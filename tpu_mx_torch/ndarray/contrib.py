"""The detection operators of ``tpu_mx/ndarray/contrib.py``, on tensors:
``box_iou``, ``box_nms``, ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection`` and ``bipartite_matching``.

Every output has a fixed shape (invalid entries are -1), as in the
reference, and none carries a gradient: each operator runs under
:func:`torch.no_grad`.  ``MultiBoxTarget`` reads nothing back to the
host, so SSD's training step queues its target generation on the card
behind the forward.  The greedy NMS of ``box_nms`` and
``MultiBoxDetection`` is one loop step per candidate, as in the
reference; it reads the number of valid candidates once, to skip the
steps that change nothing.

Ties resolve as the reference's do: ``argmax`` takes the first maximum,
both sorts are stable, and where two ground-truth boxes claim the same
anchor the later one's write stands.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["box_iou", "box_nms", "MultiBoxPrior", "MultiBoxTarget",
           "MultiBoxDetection", "bipartite_matching"]


# -- geometry (corner format: x1 y1 x2 y2) --------------------------------------
def _iou_corner(a, b):
    """a: (..., A, 4), b: (..., M, 4) -> (..., A, M)."""
    ax1, ay1, ax2, ay2 = a.unsqueeze(-2).unbind(-1)           # (..., A, 1)
    bx1, by1, bx2, by2 = b.unsqueeze(-3).unbind(-1)           # (..., 1, M)
    ix1, iy1 = torch.maximum(ax1, bx1), torch.maximum(ay1, by1)
    ix2, iy2 = torch.minimum(ax2, bx2), torch.minimum(ay2, by2)
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    area_a = (ax2 - ax1).clamp_min(0) * (ay2 - ay1).clamp_min(0)
    area_b = (bx2 - bx1).clamp_min(0) * (by2 - by1).clamp_min(0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_to_corner(x):
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _corner_to_center(x):
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def _tuple(v):
    """A tuple from a number, a sequence or the string forms the
    reference takes (``"(0.1, 0.2)"``, ``"[1 2]"``)."""
    if isinstance(v, (int, float)):
        return (v,)
    if isinstance(v, str):
        return tuple(float(t) for t in
                     v.strip("()[] ").replace(",", " ").split())
    return tuple(v)


@torch.no_grad()
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU of ``(..., A, 4)`` and ``(..., M, 4)`` boxes →
    ``(..., A, M)``; ``format="center"`` takes ``(cx, cy, w, h)``."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _iou_corner(lhs, rhs)


# -- greedy NMS ------------------------------------------------------------------
_NMS_CHUNK = 1 << 26     # IoU entries held at once (256 MB of float32)


def _nms_keep(boxes, ids, valid, thresh, topk, force_suppress):
    """The keep mask of greedy NMS over ``(B, A, 4)`` boxes already sorted
    by score, best first, the valid ones first.  Candidate ``i``, while
    kept, drops every later candidate of its class (any class with
    ``force_suppress``) whose IoU with it exceeds ``thresh``.  Candidates
    past ``topk`` are dropped outright, as in the reference, and so are
    never compared: the IoU is taken among the first ``n`` candidates
    alone, ``n`` the largest count of candidates still kept in a batch
    entry, and the loop stops there, since a dropped candidate suppresses
    nothing.  The IoU rows are made in chunks of ``_NMS_CHUNK`` entries."""
    k = boxes.shape[1] if topk < 0 else min(int(topk), boxes.shape[1])
    keep = valid.clone()
    keep[:, k:] = False
    n = int(keep.sum(1).max()) if keep.numel() else 0
    head = keep[:, :n]
    later = torch.arange(n, device=boxes.device)
    rows = max(1, _NMS_CHUNK // max(1, boxes.shape[0] * n))
    for i0 in range(0, n, rows):
        i1 = min(i0 + rows, n)
        # sup[:, r, j]: candidate i0 + r, if kept, suppresses candidate j
        sup = _iou_corner(boxes[:, i0:i1], boxes[:, :n]) > thresh
        if not force_suppress:
            sup &= ids[:, i0:i1, None] == ids[:, None, :n]
        sup &= later[i0:i1, None] < later
        for i in range(i0, i1):
            head &= ~(sup[:, i - i0] & head[:, i, None])
    return keep


@torch.no_grad()
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS over rows of ``(..., A, W)`` (a score, four coordinates
    from ``coord_start`` and, with ``id_index >= 0``, a class id).  Rows
    come out sorted by score with their coordinates in ``out_format``;
    suppressed and invalid rows are all -1."""
    shape = data.shape
    x = data.reshape((-1,) + tuple(shape[-2:]))
    scores = x[..., score_index]
    boxes = x[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    ids = x[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid &= ids != background_id
    order = torch.argsort(-torch.where(valid, scores, -math.inf), dim=1,
                          stable=True)
    rows = torch.take_along_dim(x, order[..., None], 1)
    b_s = torch.take_along_dim(boxes, order[..., None], 1)
    keep = _nms_keep(b_s, torch.take_along_dim(ids, order, 1),
                     torch.take_along_dim(valid, order, 1), overlap_thresh,
                     topk, force_suppress)
    coords = _corner_to_center(b_s) if out_format == "center" else b_s
    rows = torch.cat([rows[..., :coord_start], coords,
                      rows[..., coord_start + 4:]], -1)
    out = torch.where(keep[..., None], rows, -1.0)
    return out.reshape(shape)


# -- anchors -----------------------------------------------------------------------
@torch.no_grad()
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a ``(..., H, W)`` feature map: ``(1, H·W·K, 4)`` float32
    normalized corner boxes on ``data``'s device, ``K = len(sizes) +
    len(ratios) - 1`` a position (every size at the first ratio, then the
    first size at every other ratio).  They depend only on the arguments
    and the map's size, so they are made on the host, in the reference's
    float32 arithmetic (the ``(s·√r, s/√r)`` pairs in float64, then
    cast)."""
    sizes = tuple(float(s) for s in _tuple(sizes))
    ratios = tuple(float(r) for r in _tuple(ratios))
    steps = tuple(float(s) for s in _tuple(steps))
    offsets = tuple(float(o) for o in _tuple(offsets))
    h, w = data.shape[-2], data.shape[-1]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    f32 = np.float32
    cy = (np.arange(h, dtype=f32) + f32(offsets[0])) * f32(step_y)
    cx = (np.arange(w, dtype=f32) + f32(offsets[1])) * f32(step_x)
    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    half = np.asarray(whs, np.float64).astype(f32)[None, None] / f32(2)
    centers = np.stack([cxg, cyg], -1)[:, :, None, :]
    anchors = np.concatenate([centers - half, centers + half], -1)
    if clip:
        anchors = np.clip(anchors, f32(0), f32(1))
    return torch.from_numpy(anchors.reshape(1, -1, 4)).to(data.device)


# -- training targets ------------------------------------------------------------
@torch.no_grad()
def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor matching and target encoding.

    ``anchor (1, A, 4)`` corner boxes; ``label (B, M, 5)`` rows ``[cls,
    x1, y1, x2, y2]``, padding rows with ``cls < 0``; ``cls_pred (B, C+1,
    A)`` class scores (the hardness of a negative is its largest
    non-background score).  Returns ``loc_target (B, A·4)``, ``loc_mask
    (B, A·4)``, ``cls_target (B, A)``.

    An anchor is matched to the box of its largest IoU if that reaches
    ``overlap_threshold``; then every valid box that overlaps some anchor
    claims its best anchor (the first of equal IoUs).  Each box, valid or
    padding, writes that anchor in box order, so where two boxes share a
    best anchor the later box's write stands; a box that claims nothing
    writes the anchor's own match back.  Class targets are the matched
    box's class + 1, else 0; with ``negative_mining_ratio > 0`` only the
    hardest ``max(ratio · positives, minimum_negative_samples)`` unmatched
    anchors whose best IoU is under ``negative_mining_thresh`` stay 0
    (ranked by a stable sort) and the rest become ``ignore_label``."""
    variances = tuple(float(v) for v in _tuple(variances))
    n_b, n_m = label.shape[0], label.shape[1]
    anc = anchor.reshape(-1, 4)
    n_a = anc.shape[0]
    anc_c = _corner_to_center(anc)                                # (A, 4)
    gt_cls, gt_box = label[..., 0], label[..., 1:5]
    valid_gt = gt_cls >= 0                                        # (B, M)
    iou = _iou_corner(anc, gt_box)                                # (B, A, M)
    iou = torch.where(valid_gt[:, None, :], iou, 0.0)
    best_gt = iou.argmax(2)                                       # (B, A)
    best_iou = iou.amax(2)
    matched = best_iou >= overlap_threshold
    best_anchor = iou.argmax(1)                                   # (B, M)
    force = valid_gt & (iou.amax(1) > 1e-12)
    # the last box (in box order) to write each anchor: a max over the
    # writers, which is order-free on the card
    order = torch.arange(1, n_m + 1, device=label.device).expand(n_b, n_m)
    last = torch.zeros((n_b, n_a), dtype=torch.long, device=label.device) \
        .scatter_reduce_(1, best_anchor, order, "amax")
    writer = (last - 1).clamp_min(0)
    forced = (last > 0) & torch.gather(force, 1, writer)
    matched |= forced
    best_gt = torch.where(forced, writer, best_gt)
    cls_t = torch.where(matched, torch.gather(gt_cls, 1, best_gt) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        hard = cls_pred[:, 1:].amax(1)                            # (B, A)
        is_neg = ~matched & (best_iou < negative_mining_thresh)
        num_neg = torch.clamp_min(matched.sum(1) * negative_mining_ratio,
                                  float(minimum_negative_samples))
        rank = torch.argsort(torch.argsort(
            -torch.where(is_neg, hard, -math.inf), dim=1, stable=True),
            dim=1, stable=True)
        selected = is_neg & (rank < num_neg[:, None])
        cls_t = torch.where(matched, cls_t, torch.where(
            selected, 0.0, float(ignore_label)))
    g = torch.take_along_dim(_corner_to_center(gt_box), best_gt[..., None],
                             1)                                   # (B, A, 4)
    eps = 1e-12
    aw, ah = anc_c[:, 2].clamp_min(eps), anc_c[:, 3].clamp_min(eps)
    tx = (g[..., 0] - anc_c[:, 0]) / aw / variances[0]
    ty = (g[..., 1] - anc_c[:, 1]) / ah / variances[1]
    tw = torch.log(g[..., 2].clamp_min(eps) / aw) / variances[2]
    th = torch.log(g[..., 3].clamp_min(eps) / ah) / variances[3]
    loc_t = torch.where(matched[..., None],
                        torch.stack([tx, ty, tw, th], -1), 0.0)
    loc_m = matched[..., None].expand(n_b, n_a, 4).to(loc_t.dtype)
    return loc_t.reshape(n_b, -1), loc_m.reshape(n_b, -1), cls_t


# -- inference ------------------------------------------------------------------
@torch.no_grad()
def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """Decode, filter by confidence and suppress per class: ``cls_prob
    (B, C+1, A)``, ``loc_pred (B, A·4)``, ``anchor (1, A, 4)`` → ``(B, A,
    6)`` rows ``[class_id, score, x1, y1, x2, y2]`` sorted by score, -1
    where dropped."""
    variances = tuple(float(v) for v in _tuple(variances))
    n_b, c1 = cls_prob.shape[0], cls_prob.shape[1]
    anc_c = _corner_to_center(anchor.reshape(-1, 4))
    n_a = anc_c.shape[0]
    background = (torch.arange(c1, device=cls_prob.device)
                  == background_id)[:, None]
    scores = torch.where(background, -math.inf, cls_prob)
    score, best = scores.amax(1), scores.argmax(1)                # (B, A)
    cls_id = torch.where(best > background_id, best - 1, best).float()
    valid = score > threshold
    loc = loc_pred.reshape(n_b, n_a, 4)
    cx = loc[..., 0] * variances[0] * anc_c[:, 2] + anc_c[:, 0]
    cy = loc[..., 1] * variances[1] * anc_c[:, 3] + anc_c[:, 1]
    w = torch.exp(loc[..., 2] * variances[2]) * anc_c[:, 2]
    h = torch.exp(loc[..., 3] * variances[3]) * anc_c[:, 3]
    boxes = _center_to_corner(torch.stack([cx, cy, w, h], -1))
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    order = torch.argsort(-torch.where(valid, score, -math.inf), dim=1,
                          stable=True)
    b_s = torch.take_along_dim(boxes, order[..., None], 1)
    s_s = torch.take_along_dim(score, order, 1)
    c_s = torch.take_along_dim(cls_id, order, 1)
    keep = _nms_keep(b_s, c_s, torch.take_along_dim(valid, order, 1),
                     nms_threshold, nms_topk, force_suppress)
    rows = torch.cat([c_s[..., None], s_s[..., None], b_s], -1)
    return torch.where(keep[..., None], rows, -1.0)


# -- matching --------------------------------------------------------------------
@torch.no_grad()
def bipartite_matching(data, is_ascend=False, threshold=None, topk=-1):
    """Greedy bipartite matching on ``(B, N, M)`` scores: ``min(N, M)``
    (or ``topk``) rounds, each taking the best remaining pair (the first
    of equal scores, row-major) if it passes ``threshold`` and retiring
    its row and column.  Returns ``(row_assignments (B, N),
    col_assignments (B, M))`` as float32, -1 where unmatched."""
    if threshold is None:
        raise ValueError("bipartite_matching requires threshold")
    n_b, n, m = data.shape
    rounds = min(n, m) if topk < 0 else min(topk, n, m)
    big = float(np.finfo(np.float32).max)
    sc = data.float().clone()
    thr = threshold
    if is_ascend:
        sc, thr = -sc, -threshold
    row = torch.full((n_b, n), -1.0, device=data.device)
    col = torch.full((n_b, m), -1.0, device=data.device)
    rows_of = torch.arange(n, device=data.device)
    cols_of = torch.arange(m, device=data.device)
    for _ in range(rounds):
        flat = sc.reshape(n_b, -1).argmax(1)                      # (B,)
        i, j = flat // m, flat % m
        ok = torch.gather(sc.reshape(n_b, -1), 1, flat[:, None])[:, 0] >= thr
        row = torch.where(ok[:, None] & (rows_of == i[:, None]),
                          j[:, None].float(), row)
        col = torch.where(ok[:, None] & (cols_of == j[:, None]),
                          i[:, None].float(), col)
        retire = ok[:, None, None] & ((rows_of == i[:, None])[:, :, None]
                                      | (cols_of == j[:, None])[:, None, :])
        sc = torch.where(retire, -big, sc)
    return row, col
