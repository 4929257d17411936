"""The vision operators of ``tpu_mx/ndarray/vision_ops.py``, on tensors:
ROI pooling and alignment (plain, position-sensitive, deformable), the
spatial transformer's grid and sampler, resizing, RPN proposals and the
FlowNet correlation.

Every ROI operator samples a fixed grid per bin and gathers it for all
ROIs at once (flat indices into the feature map, ``torch.take``), so
there is no loop over ROIs; gradients are PyTorch's autograd through the
gathers and the sampling weights, as the reference's come from
``jax.vjp``.  The conventions are the reference's:

- bilinear sampling clamps a coordinate to the image box before it
  computes the weights, so a sample outside converges to the border
  value (``_bilinear``); the position-sensitive operators read each
  sample from its own channel only;
- ``ROIPooling`` and ``PSROIPooling`` take the max (average) over a
  fixed 4 x 4 floor-sampled grid a bin, ``ROIAlign`` the average of
  ``sample_ratio``² bilinear samples;
- ``BilinearResize2D`` and ``UpSampling`` follow ``jax.image.resize``:
  half-pixel centres, and a triangle filter widened by the shrink
  factor (antialiasing) where an axis shrinks;
- ``Proposal`` decodes, clips, filters by size, keeps the top
  ``rpn_pre_nms_top_n`` by a stable sort and suppresses with
  :func:`~tpu_mx_torch.ndarray.contrib.box_nms`'s greedy loop (one
  step a kept candidate); its output is the fixed ``(N,
  rpn_post_nms_top_n, 5)``, the suppressed rows padded with the best
  box;
- ``Correlation`` is a loop over the displacements, each a product, a
  channel sum and a window sum.

A clamp at a bound passes half the gradient there, as ``jnp.clip``'s
does (``torch.maximum``/``torch.minimum``, not ``torch.clamp``).  None of
these reaches a Pallas kernel in the reference, so none is a kernel of
the port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import _op

__all__ = ["ROIPooling", "ROIAlign", "PSROIPooling",
           "DeformablePSROIPooling", "BilinearSampler", "GridGenerator",
           "SpatialTransformer", "BilinearResize2D", "UpSampling",
           "Proposal", "MultiProposal", "Correlation"]


def _full(v, like):
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype)
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def _clip(x, lo, hi):
    """``jnp.clip``: ``max`` then ``min``, half the gradient at a tie."""
    return torch.minimum(torch.maximum(x, _full(lo, x)), _full(hi, x))


def _grid(n, s, like):
    """``arange(n)[:, None] + (arange(s)[None, :] + 0.5) / s``: the sample
    offsets of ``n`` bins of ``s`` samples, in bin units."""
    a = torch.arange(n, device=like.device, dtype=like.dtype)[:, None]
    return a + (torch.arange(s, device=like.device, dtype=like.dtype)[None, :]
                + 0.5) / s


def _take(data, b, c, yi, xi):
    """``data[b, c, yi, xi]`` with broadcast index tensors, as one flat
    gather."""
    _, C, H, W = data.shape
    idx = ((b * C + c) * H + yi) * W + xi
    return torch.take(data, idx)


def _bilinear(data, b, c, ys, xs):
    """Bilinear samples of ``data`` (N, C, H, W) at fractional ``(ys,
    xs)`` of batch entry ``b`` and channel ``c`` (broadcast index
    tensors).  The coordinates are clamped to the image box first, so a
    sample outside is the border value."""
    H, W = data.shape[-2:]
    ys = _clip(ys, 0.0, H - 1.0)
    xs = _clip(xs, 0.0, W - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = (y0i + 1).clamp(0, H - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    g = lambda yi, xi: _take(data, b, c, yi, xi)  # noqa: E731
    return (g(y0i, x0i) * (1 - wy1) * (1 - wx1)
            + g(y0i, x1i) * (1 - wy1) * wx1
            + g(y1i, x0i) * wy1 * (1 - wx1)
            + g(y1i, x1i) * wy1 * wx1)


def _ps_chan(output_dim, k, g, device):
    """(D, k, k) position-sensitive channel: output ``d`` at bin ``(i,
    j)`` reads input channel ``(d·g + gh_i)·g + gh_j``."""
    gh = torch.clamp((torch.arange(k, device=device) * g) // k, 0, g - 1)
    d = torch.arange(output_dim, device=device)
    return (d[:, None, None] * g + gh[None, :, None]) * g + gh[None, None, :]


def _roi_batch(rois):
    return rois[:, 0].long()


def ROIPooling(data, rois, pooled_size=None, spatial_scale=1.0, **kw):
    """Max over each bin of a ROI: ``data (N, C, H, W)``, ``rois (R, 5)``
    rows ``[batch, x1, y1, x2, y2]`` in image coordinates → ``(R, C, ph,
    pw)``.  Corners are rounded after scaling; each bin's max is over a
    4 x 4 floor-sampled grid."""
    ph, pw = pooled_size
    _, C, H, W = data.shape
    S = 4
    r = rois.to(data.dtype)
    x1, y1, x2, y2 = torch.round(r[:, 1:5] * spatial_scale).unbind(-1)
    one = _full(1.0, r)
    roi_h = torch.maximum(y2 - y1 + 1, one)
    roi_w = torch.maximum(x2 - x1 + 1, one)
    gy = y1[:, None, None] + (roi_h / ph)[:, None, None] * _grid(ph, S, r)
    gx = x1[:, None, None] + (roi_w / pw)[:, None, None] * _grid(pw, S, r)
    yi = torch.floor(gy).long().clamp(0, H - 1)           # (R, ph, S)
    xi = torch.floor(gx).long().clamp(0, W - 1)           # (R, pw, S)
    b = _roi_batch(rois)[:, None, None, None, None, None]
    c = torch.arange(C, device=data.device)[None, :, None, None, None, None]
    vals = _take(data, b, c, yi[:, None, :, :, None, None],
                 xi[:, None, None, None, :, :])   # (R, C, ph, S, pw, S)
    return vals.amax(dim=(3, 5))


def ROIAlign(data, rois, pooled_size=None, spatial_scale=1.0, sample_ratio=2,
             position_sensitive=False, **kw):
    """The average of ``sample_ratio``² bilinear samples a bin, no
    rounding (Mask R-CNN's RoIAlign) → ``(R, C, ph, pw)``; with
    ``position_sensitive`` (R-FCN) output channel ``d`` at bin ``(i, j)``
    reads input channel ``d·ph·pw + i·pw + j`` alone → ``(R, C/(ph·pw),
    ph, pw)``."""
    ph, pw = pooled_size
    S = max(int(sample_ratio), 1)
    C = data.shape[1]
    r = rois.to(data.dtype)
    x1, y1, x2, y2 = (r[:, 1:5] * spatial_scale).unbind(-1)
    one = _full(1.0, r)
    roi_h = torch.maximum(y2 - y1, one)
    roi_w = torch.maximum(x2 - x1, one)
    gy = y1[:, None, None] + (roi_h / ph)[:, None, None] * _grid(ph, S, r)
    gx = x1[:, None, None] + (roi_w / pw)[:, None, None] * _grid(pw, S, r)
    if position_sensitive:
        out_dim = C // (ph * pw)
        d = torch.arange(out_dim, device=data.device)
        chan = (d[:, None, None] * ph * pw
                + torch.arange(ph, device=data.device)[None, :, None] * pw
                + torch.arange(pw, device=data.device)[None, None, :])
        b = _roi_batch(rois)[:, None, None, None, None, None]
        ys = gy[:, None, :, None, :, None]                # (R,1,ph,1,S,1)
        xs = gx[:, None, None, :, None, :]                # (R,1,1,pw,1,S)
        vals = _bilinear(data, b, chan[None, :, :, :, None, None], ys, xs)
        return vals.mean(dim=(4, 5))                      # (R, D, ph, pw)
    b = _roi_batch(rois)[:, None, None, None, None, None]
    c = torch.arange(C, device=data.device)[None, :, None, None, None, None]
    ys = gy[:, None, :, :, None, None]                    # (R,1,ph,S,1,1)
    xs = gx[:, None, None, None, :, :]                    # (R,1,1,1,pw,S)
    vals = _bilinear(data, b, c, ys, xs)                  # (R,C,ph,S,pw,S)
    return vals.mean(dim=(3, 5))


def PSROIPooling(data, rois, spatial_scale=1.0, output_dim=None,
                 pooled_size=None, group_size=0, **kw):
    """Position-sensitive ROI pooling (R-FCN): ``data (N,
    output_dim·g·g, H, W)`` → ``(R, output_dim, k, k)``, output ``d`` at
    bin ``(i, j)`` the average of its group cell's channel over a 4 x 4
    floor-sampled grid (the reference's, which subsamples bins wider than
    about four cells)."""
    k = int(pooled_size)
    g = int(group_size) or k
    H, W = data.shape[-2:]
    S = 4
    r = rois.to(data.dtype)
    x1 = torch.round(r[:, 1]) * spatial_scale
    y1 = torch.round(r[:, 2]) * spatial_scale
    x2 = torch.round(r[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(r[:, 4] + 1.0) * spatial_scale
    tenth = _full(0.1, r)
    roi_h = torch.maximum(y2 - y1, tenth)
    roi_w = torch.maximum(x2 - x1, tenth)
    gy = y1[:, None, None] + (roi_h / k)[:, None, None] * _grid(k, S, r)
    gx = x1[:, None, None] + (roi_w / k)[:, None, None] * _grid(k, S, r)
    yi = torch.floor(gy).long().clamp(0, H - 1)
    xi = torch.floor(gx).long().clamp(0, W - 1)
    chan = _ps_chan(output_dim, k, g, data.device)
    b = _roi_batch(rois)[:, None, None, None, None, None]
    vals = _take(data, b, chan[None, :, :, :, None, None],
                 yi[:, None, :, None, :, None], xi[:, None, None, :, None, :])
    return vals.mean(dim=(4, 5))                          # (R, D, k, k)


def DeformablePSROIPooling(data, rois, trans=None, spatial_scale=1.0,
                           output_dim=None, group_size=1, pooled_size=None,
                           part_size=0, sample_per_part=1, trans_std=0.0,
                           no_trans=False, **kw):
    """Deformable position-sensitive ROI pooling (Deformable ConvNets):
    :func:`PSROIPooling` with bilinear samples, ``sample_per_part``² a
    bin, each bin's window shifted by its offset from ``trans (R,
    2·num_classes, part, part)`` times ``trans_std`` and the ROI's size;
    ``no_trans`` (or no ``trans``) leaves the windows in place.  A sample
    outside the image reads the border (the reference's, where the CUDA
    kernel drops it from the average)."""
    k = int(pooled_size)
    g = int(group_size) or k
    part = int(part_size) or k
    S = max(int(sample_per_part), 1)
    if not no_trans and trans is None:
        raise ValueError(
            "DeformablePSROIPooling: no_trans=False requires the `trans` "
            "offset input (the reference errors too); pass no_trans=True "
            "for the undeformed variant")
    use_trans = not no_trans and trans is not None
    r = rois.to(data.dtype)
    x1 = torch.round(r[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(r[:, 2]) * spatial_scale - 0.5
    x2 = torch.round(r[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = torch.round(r[:, 4] + 1.0) * spatial_scale - 0.5
    tenth = _full(0.1, r)
    roi_h = torch.maximum(y2 - y1, tenth)
    roi_w = torch.maximum(x2 - x1, tenth)
    bin_h, bin_w = roi_h / k, roi_w / k                   # (R,)
    dev = data.device
    ii = torch.arange(k, device=dev)
    if use_trans:
        ncls = trans.shape[1] // 2
        ch_per_cls = max(output_dim // ncls, 1)
        pi = torch.clamp((ii * part) // k, 0, part - 1)
        dy = trans[:, 0::2][:, :, pi[:, None], pi[None, :]]  # (R, ncls, k, k)
        dx = trans[:, 1::2][:, :, pi[:, None], pi[None, :]]
        cls_of_d = (torch.arange(output_dim, device=dev) // ch_per_cls) \
            .clamp(max=ncls - 1)
        off_y = dy[:, cls_of_d] * trans_std * roi_h[:, None, None, None]
        off_x = dx[:, cls_of_d] * trans_std * roi_w[:, None, None, None]
    else:
        off_y = off_x = r.new_zeros((r.shape[0], output_dim, k, k))
    sub = (torch.arange(S, device=dev, dtype=r.dtype) + 0.5) / S
    iif = ii.to(r.dtype)
    base_y = y1[:, None, None] + iif[None, :, None] * bin_h[:, None, None] \
        + r.new_zeros((k, k))                             # (R, k, k)
    base_x = x1[:, None, None] + iif[None, None, :] * bin_w[:, None, None] \
        + r.new_zeros((k, k))
    ys = (base_y[:, None, :, :, None, None] + off_y[..., None, None]
          + bin_h[:, None, None, None, None, None]
          * sub[None, None, None, None, :, None])
    xs = (base_x[:, None, :, :, None, None] + off_x[..., None, None]
          + bin_w[:, None, None, None, None, None]
          * sub[None, None, None, None, None, :])
    chan = _ps_chan(output_dim, k, g, dev)
    b = _roi_batch(rois)[:, None, None, None, None, None]
    vals = _bilinear(data, b, chan[None, :, :, :, None, None], ys, xs)
    return vals.mean(dim=(4, 5))                          # (R, D, k, k)


def GridGenerator(data, transform_type="affine", target_shape=None, **kw):
    """A sampling grid ``(N, 2, H, W)`` of ``(x, y)`` in [-1, 1]: from
    affine parameters ``(N, 6)`` over ``target_shape``, or (``"warp"``)
    from a flow field ``(N, 2, H, W)`` in pixels."""
    if transform_type == "affine":
        H, W = target_shape
        ys = torch.linspace(-1.0, 1.0, H, device=data.device,
                            dtype=data.dtype)
        xs = torch.linspace(-1.0, 1.0, W, device=data.device,
                            dtype=data.dtype)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
        out = torch.einsum("nij,jk->nik", data.reshape(-1, 2, 3), base)
        return out.reshape(-1, 2, H, W)
    N, _, H, W = data.shape
    ys = torch.arange(H, device=data.device, dtype=data.dtype)
    xs = torch.arange(W, device=data.device, dtype=data.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px = (data[:, 0] + gx) * 2.0 / max(W - 1, 1) - 1.0
    py = (data[:, 1] + gy) * 2.0 / max(H - 1, 1) - 1.0
    return torch.stack([px, py], 1)


def BilinearSampler(data, grid, **kw):
    """``data (N, C, H, W)`` sampled at ``grid (N, 2, Ho, Wo)``'s ``(x,
    y)`` in [-1, 1] (the spatial transformer's sampler): bilinear with
    the border clamp, zero outside [-1, 1]."""
    N, C, H, W = data.shape
    gx, gy = grid[:, 0], grid[:, 1]
    xs = (gx + 1.0) * (W - 1) / 2.0
    ys = (gy + 1.0) * (H - 1) / 2.0
    b = torch.arange(N, device=data.device)[:, None, None, None]
    c = torch.arange(C, device=data.device)[None, :, None, None]
    vals = _bilinear(data, b, c, ys[:, None], xs[:, None])   # (N,C,Ho,Wo)
    inside = (gx >= -1.0) & (gx <= 1.0) & (gy >= -1.0) & (gy <= 1.0)
    return vals * inside[:, None].to(vals.dtype)


def SpatialTransformer(data, loc, target_shape=None,
                       transform_type="affine", sampler_type="bilinear", **kw):
    """The affine spatial transformer: :func:`GridGenerator` then
    :func:`BilinearSampler`."""
    return BilinearSampler(data, GridGenerator(loc, "affine", target_shape))


def _resize(x, h, w, mode):
    """``jax.image.resize`` of an NCHW tensor: half-pixel centres, and
    antialiasing (a widened triangle filter) on a shrinking axis."""
    if mode == "nearest":
        return F.interpolate(x, size=(h, w), mode="nearest")
    shrink = h < x.shape[2] or w < x.shape[3]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrink)


def BilinearResize2D(data, height=None, width=None, scale_height=None,
                     scale_width=None, **kw):
    """Bilinear resize of NCHW ``data`` to ``(height, width)`` (or its
    size times the scales)."""
    h = height if height else int(data.shape[2] * scale_height)
    w = width if width else int(data.shape[3] * scale_width)
    return _resize(data, h, w, "linear")


def UpSampling(*data, scale=2, sample_type="nearest", num_filter=0,
               num_args=1, **kw):
    """``data[0]`` upsampled ``scale`` times (nearest or bilinear)."""
    x = data[0]
    return _resize(x, x.shape[2] * scale, x.shape[3] * scale,
                   "nearest" if sample_type == "nearest" else "linear")


def _make_anchors(base_size, ratios, scales):
    """The reference's ``generate_anchors``: ``(A, 4)`` float32 windows
    around (0, 0), every scale of the first ratio first."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(anchors, np.float32)


def Proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False, **kw):
    """RPN proposals: ``cls_prob (N, 2A, Hf, Wf)``, ``bbox_pred (N, 4A,
    Hf, Wf)``, ``im_info (N, 3)`` rows ``[height, width, scale]`` →
    ``(N, rpn_post_nms_top_n, 5)`` rows ``[batch, x1, y1, x2, y2]`` (and
    with ``output_score`` the scores, ``(N, top, 1)``, -1 where
    suppressed).  Anchors decoded by the deltas, clipped to the image,
    those under ``rpn_min_size·scale`` scored -1, the top
    ``rpn_pre_nms_top_n`` kept (stable: the lower index first among
    ties), then greedy NMS at ``threshold`` over the first
    ``rpn_post_nms_top_n`` candidates; of the sorted candidates the
    first ``rpn_post_nms_top_n`` rows are returned, a suppressed one
    replaced by the best box."""
    from .contrib import _nms_keep
    N, A2, Hf, Wf = cls_prob.shape
    A = A2 // 2
    dev, dt = cls_prob.device, cls_prob.dtype
    anchors = torch.from_numpy(
        _make_anchors(feature_stride, ratios, scales)).to(dev)    # (A, 4)
    sx = torch.arange(Wf, device=dev) * feature_stride
    sy = torch.arange(Hf, device=dev) * feature_stride
    shift_y, shift_x = torch.meshgrid(sy, sx, indexing="ij")      # (Hf, Wf)
    shifts = torch.stack([shift_x, shift_y, shift_x, shift_y], -1)
    all_anchors = (anchors[None, None] + shifts[:, :, None]).reshape(-1, 4)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)       # (N, n)
    dx, dy, dw, dh = [bbox_pred[:, i::4].permute(0, 2, 3, 1).reshape(N, -1)
                      for i in range(4)]
    aw = all_anchors[:, 2] - all_anchors[:, 0] + 1
    ah = all_anchors[:, 3] - all_anchors[:, 1] + 1
    acx = all_anchors[:, 0] + 0.5 * (aw - 1)
    acy = all_anchors[:, 1] + 0.5 * (ah - 1)
    cx = dx * aw + acx
    cy = dy * ah + acy
    w = torch.exp(_clip(dw, -10.0, 10.0)) * aw
    h = torch.exp(_clip(dh, -10.0, 10.0)) * ah
    im = im_info.to(dt)
    zero = _full(0.0, fg)
    x1 = _clip(cx - 0.5 * (w - 1), zero, im[:, 1:2] - 1)
    y1 = _clip(cy - 0.5 * (h - 1), zero, im[:, 0:1] - 1)
    x2 = _clip(cx + 0.5 * (w - 1), zero, im[:, 1:2] - 1)
    y2 = _clip(cy + 0.5 * (h - 1), zero, im[:, 0:1] - 1)
    min_size = rpn_min_size * im[:, 2:3]
    keep = (x2 - x1 + 1 >= min_size) & (y2 - y1 + 1 >= min_size)
    fg_k = torch.where(keep, fg, -1.0)
    k = min(rpn_pre_nms_top_n, fg_k.shape[1])
    top_sc, top_idx = torch.sort(fg_k, dim=1, descending=True, stable=True)
    top_sc, top_idx = top_sc[:, :k], top_idx[:, :k]
    boxes = torch.take_along_dim(torch.stack([x1, y1, x2, y2], -1),
                                 top_idx[..., None], 1)           # (N, k, 4)
    det = torch.cat([top_sc[..., None], boxes], -1)               # (N, k, 5)
    # box_nms(det, overlap_thresh=threshold, topk=rpn_post_nms_top_n,
    # coord_start=1, score_index=0), with the rows' gradients kept
    valid = det[..., 0] > 0.0
    order = torch.argsort(-torch.where(valid, det[..., 0].detach(),
                                       -float("inf")), dim=1, stable=True)
    rows = torch.take_along_dim(det, order[..., None], 1)
    with torch.no_grad():
        kept = _nms_keep(rows[..., 1:5].detach(), torch.zeros_like(top_sc),
                         torch.take_along_dim(valid, order, 1), threshold,
                         rpn_post_nms_top_n, False)
    out = torch.where(kept[..., None], rows, -1.0)[:, :rpn_post_nms_top_n]
    ok = out[..., 0] >= 0
    out = torch.where(ok[..., None], out, out[:, :1])
    bidx = torch.arange(N, device=dev, dtype=dt)[:, None, None] \
        .expand(N, out.shape[1], 1)
    rois = torch.cat([bidx, out[..., 1:5]], -1)
    if output_score:
        return rois, torch.where(ok, out[..., 0], -1.0)[..., None]
    return rois


def MultiProposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                  rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                  scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                  feature_stride=16, output_score=False, iou_loss=False,
                  **kw):
    """:func:`Proposal`, which takes a batch already."""
    return Proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                    rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                    ratios, feature_stride, output_score, iou_loss)


def Correlation(data1, data2, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True, **kw):
    """The FlowNet cost volume: for each displacement ``d`` of the
    ``(2·⌊md/stride2⌋+1)²`` neighbourhood, the mean over channels and the
    ``K x K`` window of ``f1·shift(f2, d)`` (``|f1 - f2|`` without
    ``is_multiply``) on the output grid subsampled by ``stride1``,
    computed in float32 → ``(B, D², th, tw)`` in ``data1``'s type."""
    if kernel_size % 2 != 1:
        raise ValueError("Correlation kernel_size must be odd")
    b, c, h, w = data1.shape
    kr = (kernel_size - 1) // 2
    bd = max_displacement + kr
    ph, pw = h + 2 * pad_size, w + 2 * pad_size
    th = int(-(-(ph - 2 * bd) // stride1))
    tw = int(-(-(pw - 2 * bd) // stride1))
    if th < 1 or tw < 1:
        raise ValueError("Correlation: displacement/kernel larger "
                         "than the padded input")
    pads = (pad_size,) * 4
    p1 = F.pad(data1.float(), pads)
    p2 = F.pad(data2.float(), pads)
    norm = float(kernel_size * kernel_size * c)
    y0 = x0 = bd - kr
    ext_h, ext_w = ph - 2 * (bd - kr), pw - 2 * (bd - kr)
    s1 = p1[:, :, y0:y0 + ext_h, x0:x0 + ext_w]
    r = max_displacement // stride2
    disps = range(-r * stride2, r * stride2 + 1, stride2)
    ones = torch.ones((1, 1, kernel_size, kernel_size), device=data1.device)
    planes = []
    for dy in disps:
        for dx in disps:
            s2 = p2[:, :, y0 + dy:y0 + dy + ext_h, x0 + dx:x0 + dx + ext_w]
            prod = s1 * s2 if is_multiply else (s1 - s2).abs()
            csum = prod.sum(dim=1)                        # (B, ext_h, ext_w)
            win = csum if kernel_size == 1 else \
                F.conv2d(csum[:, None], ones)[:, 0]
            planes.append(win[:, ::stride1, ::stride1])
    out = torch.stack(planes, dim=1) / norm
    return out.to(data1.dtype)


# each operator with the imperative face of ndarray/ops.py: arrays in,
# arrays out; tensors in, tensors out
for _name in __all__:
    globals()[_name] = _op(globals()[_name])
del _name
