"""Evaluation metrics: decoded token streams -> boxes -> P/R/F1.

Ports `plankassembly_tpu/metrics.py`, `ops/matching.py` and the IoU of
`ops/boxes.py`. `program_boxes` and the IoU run as tensor code on the
tokens' device. The matching is the same maximum-cardinality bipartite
matching on the IoU > threshold graph that the JAX package solves on
device (every above-threshold pair costs the same, so the reference's
Hungarian assignment reduces to it); with at most ~21 boxes per program it
runs on the host, by augmenting paths. `hungarian_match_host` keeps the
reference matcher bit for bit (scipy).
"""
from __future__ import annotations

import numpy as np
import torch


def program_boxes(samples: torch.Tensor, end: int = 512, dof: int = 6,
                  drop_bbox: bool = True, drop_zero_extent: bool = True):
    """(B, S) tokens -> (boxes (B, P, 6) float32, valid (B, P) bool), with
    P = S // dof. Row 0 (the global bbox) stays in slot 0 and is invalid
    when `drop_bbox`; zero-extent planks are invalid when
    `drop_zero_extent` (the prediction side of the reference eval)."""
    samples = torch.as_tensor(samples)
    B, S = samples.shape
    P = S // dof
    hit = samples == end
    any_end = hit.any(dim=1)
    first_end = torch.where(any_end, hit.int().argmax(dim=1),
                            torch.full_like(any_end, S, dtype=torch.long))
    num_planks = first_end // dof
    boxes = samples[:, : P * dof].reshape(B, P, dof).float()
    ids = torch.arange(P, device=samples.device)[None, :]
    valid = ids < num_planks[:, None]
    if drop_bbox:
        valid = valid & (ids >= 1)
    if drop_zero_extent:
        extent = (boxes[..., dof // 2:] - boxes[..., : dof // 2]).abs()
        valid = valid & (extent != 0).all(dim=-1)
    return boxes, valid


def pairwise_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of all pairs of 3D boxes (x1,y1,z1,x2,y2,z2): (N,6),(M,6) ->
    (N,M); empty or degenerate overlaps give 0."""
    b1, b2 = boxes1.float(), boxes2.float()
    vol1 = (b1[..., 3:] - b1[..., :3]).prod(dim=-1)
    vol2 = (b2[..., 3:] - b2[..., :3]).prod(dim=-1)
    lwh = (torch.minimum(b1[..., :, None, 3:], b2[..., None, :, 3:])
           - torch.maximum(b1[..., :, None, :3], b2[..., None, :, :3]))
    inter = lwh.clamp(min=0.0).prod(dim=-1)
    union = vol1[..., :, None] + vol2[..., None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def max_bipartite_matching(adj: np.ndarray) -> int:
    """Size of a maximum-cardinality matching of a bipartite (N, M) bool
    adjacency (Kuhn's augmenting paths)."""
    n, m = adj.shape
    match_r = [-1] * m

    def augment(i, seen):
        for j in np.flatnonzero(adj[i]):
            if not seen[j]:
                seen[j] = True
                if match_r[j] == -1 or augment(match_r[j], seen):
                    match_r[j] = i
                    return True
        return False

    return sum(augment(i, [False] * m) for i in range(n))


def batch_scores(pred_samples, gt_samples, end: int = 512, dof: int = 6,
                 threshold: float = 0.5):
    """(B,) float32 per-program precision, recall and F1 from token
    streams (`plankassembly_tpu/metrics.py::batch_scores`)."""
    pred_samples = torch.as_tensor(pred_samples)
    gt_samples = torch.as_tensor(gt_samples).to(pred_samples.device)
    pred_boxes, pred_valid = program_boxes(pred_samples, end=end, dof=dof)
    gt_boxes, gt_valid = program_boxes(gt_samples, end=end, dof=dof,
                                       drop_zero_extent=False)
    iou = pairwise_iou_3d(pred_boxes, gt_boxes)
    adj = ((iou > threshold) & pred_valid[:, :, None]
           & gt_valid[:, None, :]).cpu().numpy()
    tp = torch.tensor([max_bipartite_matching(a) for a in adj],
                      dtype=torch.float32)
    num_pred = pred_valid.sum(dim=1).float().cpu()
    num_label = gt_valid.sum(dim=1).float().cpu()
    zero = torch.zeros_like(tp)
    prec = torch.where(num_pred > 0, tp / num_pred.clamp(min=1), zero)
    rec = torch.where(num_label > 0, tp / num_label.clamp(min=1), zero)
    f1 = prec * rec * 2 / (prec + rec + 1e-10)
    return prec, rec, f1


def metric_sums(pred_samples, gt_samples, valid, end: int = 512, dof: int = 6,
                threshold: float = 0.5):
    """(sum_prec, sum_rec, sum_f1, count) over the rows where `valid`."""
    prec, rec, f1 = batch_scores(pred_samples, gt_samples, end=end, dof=dof,
                                 threshold=threshold)
    v = torch.as_tensor(valid).cpu().float()
    return (prec * v).sum(), (rec * v).sum(), (f1 * v).sum(), v.sum()


class Criterion:
    """Macro-averaged running precision / recall / F1 (the reference's
    metric, `plankassembly_tpu/metrics.py::Criterion`), on host floats;
    updates take scalars or arrays (summed)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.precision = 0.0
        self.recall = 0.0
        self.fmeasure = 0.0
        self.total = 0

    def update(self, prec, rec, f1, count: int = 1):
        self.precision += float(np.sum(np.asarray(prec)))
        self.recall += float(np.sum(np.asarray(rec)))
        self.fmeasure += float(np.sum(np.asarray(f1)))
        self.total += int(count)

    def update_batch(self, prec, rec, f1, valid_mask=None):
        prec, rec, f1 = np.asarray(prec), np.asarray(rec), np.asarray(f1)
        if valid_mask is not None:
            mask = np.asarray(valid_mask)
            prec, rec, f1 = prec[mask], rec[mask], f1[mask]
        self.update(prec, rec, f1, count=prec.size)

    def compute(self):
        total = max(self.total, 1)
        return (self.precision / total, self.recall / total,
                self.fmeasure / total)


def build_criterion() -> Criterion:
    return Criterion()


LARGE_COST_VALUE = 100000


def hungarian_match_host(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
                         threshold: float = 0.5):
    """The reference matcher (`third_party/matcher.py:29-61`) on
    numpy/scipy. Returns (prec, rec, f1) floats."""
    from scipy.optimize import linear_sum_assignment

    pred_boxes = np.asarray(pred_boxes, dtype=np.float32).reshape(-1, 6)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float32).reshape(-1, 6)
    num_pred, num_label = len(pred_boxes), len(gt_boxes)
    if num_pred == 0 or num_label == 0:
        return 0.0, 0.0, 0.0
    vol1 = np.prod(pred_boxes[:, 3:] - pred_boxes[:, :3], axis=-1)
    vol2 = np.prod(gt_boxes[:, 3:] - gt_boxes[:, :3], axis=-1)
    lwh = (np.minimum(pred_boxes[:, None, 3:], gt_boxes[None, :, 3:])
           - np.maximum(pred_boxes[:, None, :3], gt_boxes[None, :, :3]))
    inter = np.prod(np.clip(lwh, 0, None), axis=-1)
    union = vol1[:, None] + vol2[None, :] - inter
    iou = np.where(inter > 0, inter / np.where(union == 0, 1, union), 0.0)
    cost = np.full((num_pred, num_label), LARGE_COST_VALUE, dtype=np.float64)
    cost[iou > threshold] = -1
    rows, cols = linear_sum_assignment(cost)
    tp = float(np.sum(iou[rows, cols] >= threshold))
    prec = tp / num_pred
    rec = tp / num_label
    f1 = prec * rec * 2 / (prec + rec + 1e-10)
    return prec, rec, f1
