"""Self-contained nuScenes detection metrics (devkit-free, devkit-exact): a
numpy copy of ``isfusion_tpu/core/evaluation/nuscenes_eval.py``, so the
port imports nothing of the JAX package; the two give equal metrics.

Implements the `detection_cvpr_2019` protocol of nuscenes-devkit
(`nuscenes/eval/detection/algo.py` + `loaders.filter_eval_boxes`, which the
reference invokes through `NuScenesDataset._evaluate_single:421`):

- per-class detection range filtering of BOTH ground truth and predictions
  (car/truck/bus/trailer/construction_vehicle 50 m, pedestrian/motorcycle/
  bicycle 40 m, traffic_cone/barrier 30 m; ego-frame BEV distance);
- ground-truth boxes with zero lidar+radar points removed;
- matching by BEV center distance at thresholds {0.5, 1, 2, 4} m, greedy
  over descending confidence, one match per GT, same class only;
- per-class AP = normalized area under the 101-point interpolated
  (recall, precision) curve with (0.1, 0.1) min-recall/min-precision;
- TP errors at the 2 m threshold: ATE (translation), ASE (1 - IoU of
  size-aligned boxes), AOE (yaw, period pi for barrier, absent for
  traffic_cone), AVE (velocity; absent for barrier/traffic_cone),
  AAE (1 - attribute accuracy; absent for barrier/traffic_cone) —
  cumulative-mean over matches, interpolated on the confidence grid,
  averaged from min-recall to max achieved recall;
- NDS = (5*mAP + sum over the 5 TP scores of (1 - min(1, err))) / 10.

GT attribute names come from the info pkls when the converter stored them
(`gt_attrs`); without them AAE falls back to a perfect score and the
result is flagged with ``attr_err_available=False``.

Box layout: (x, y, z, dx, dy, dz, yaw[, vx, vy]) in the LiDAR frame —
center distances and yaw differences are rotation/translation invariant
between lidar and global frames up to the ego offset, which callers pass
via ``ego_translation`` per sample for the range filter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
TP_DIST_TH = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err",
              "attr_err")
# devkit eval_detection_configs['detection_cvpr_2019']['class_range']
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
# devkit constants.TP_METRICS exclusions
LEAVE_OUT = {
    "traffic_cone": ("attr_err", "vel_err", "orient_err"),
    "barrier": ("attr_err", "vel_err"),
}


def _scale_iou(gt: np.ndarray, det: np.ndarray) -> float:
    """IoU of size-aligned boxes (devkit scale_iou)."""
    minima = np.minimum(gt[3:6], det[3:6])
    inter = float(np.prod(minima))
    union = float(np.prod(gt[3:6]) + np.prod(det[3:6]) - inter)
    return inter / max(union, 1e-9)


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    return min(d, period - d)


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit utils.cummean: cumulative mean ignoring NaNs."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(float))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals != 0)


def _filter_sample(boxes, labels, class_names, ego_xy, extra=None,
                   num_pts=None):
    """devkit filter_eval_boxes: class-specific range (ego BEV distance)
    + GT min-points filter."""
    keep = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        name = class_names[int(labels[i])] if 0 <= int(
            labels[i]) < len(class_names) else None
        rng = CLASS_RANGE.get(name, 50.0)
        d = float(np.linalg.norm(boxes[i][:2] - ego_xy))
        keep[i] = d <= rng
        if num_pts is not None and keep[i]:
            keep[i] = int(num_pts[i]) > 0
    out = [np.asarray(boxes)[keep], np.asarray(labels)[keep]]
    for e in (extra or []):
        out.append(np.asarray(e)[keep] if e is not None and
                   len(e) == len(keep) else None)
    return out


def _accumulate(dets: List[dict], gts: List[dict], cls_name: str,
                cls: int, dist_th: float) -> Dict[str, np.ndarray]:
    """Devkit `accumulate`: greedy center-distance matching for one class
    at one threshold across all samples."""
    npos = sum(int((g["labels"] == cls).sum()) for g in gts)
    all_rows = []
    for s, det in enumerate(dets):
        for i in np.nonzero(det["labels"] == cls)[0]:
            all_rows.append((float(det["scores"][i]), s, i))
    if npos == 0 or not all_rows:
        return dict(valid=False, npos=npos)
    all_rows.sort(key=lambda r: -r[0])

    period = np.pi if cls_name == "barrier" else 2 * np.pi
    taken = set()
    tp, fp, conf = [], [], []
    match_data = {k: [] for k in TP_METRICS}
    match_conf = []
    for score, s, i in all_rows:
        det_box = dets[s]["boxes"][i]
        gt = gts[s]
        best_j, best_d = -1, float("inf")
        for j in np.nonzero(gt["labels"] == cls)[0]:
            if (s, j) in taken:
                continue
            d = float(np.linalg.norm(det_box[:2] - gt["boxes"][j][:2]))
            if d < best_d:
                best_d, best_j = d, j
        if best_j >= 0 and best_d < dist_th:
            taken.add((s, best_j))
            tp.append(1)
            fp.append(0)
            g = gt["boxes"][best_j]
            match_data["trans_err"].append(best_d)
            match_data["scale_err"].append(1.0 - _scale_iou(g, det_box))
            match_data["orient_err"].append(
                _yaw_diff(float(g[6]), float(det_box[6]), period))
            if g.shape[0] >= 9 and det_box.shape[0] >= 9:
                match_data["vel_err"].append(
                    float(np.linalg.norm(g[7:9] - det_box[7:9])))
            else:
                match_data["vel_err"].append(np.nan)
            g_attr = gt.get("attrs")
            d_attr = dets[s].get("attrs")
            if g_attr is not None and d_attr is not None and \
                    str(g_attr[best_j]) not in ("", "None"):
                match_data["attr_err"].append(
                    0.0 if str(g_attr[best_j]) == str(d_attr[i]) else 1.0)
            else:
                match_data["attr_err"].append(np.nan)
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)
        conf.append(score)

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)
    rec_interp = np.linspace(0, 1, 101)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, np.asarray(conf, np.float64),
                       right=0)

    # devkit: cummean over matches, then interpolate on the CONFIDENCE
    # grid (both descending -> reverse for np.interp)
    out_err = {}
    for k in TP_METRICS:
        e = np.asarray(match_data[k], np.float64)
        if len(e) == 0:
            out_err[k] = np.ones(101)
            continue
        tmp = _cummean(e)
        out_err[k] = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1],
                               tmp[::-1])[::-1]
    nz = np.nonzero(conf_i)[0]
    return dict(valid=True, npos=npos, precision=prec_i, recall=rec_interp,
                confidence=conf_i, errors=out_err,
                max_recall_ind=int(nz[-1]) if len(nz) else 0)


def _calc_ap(md: dict) -> float:
    prec = md["precision"].copy()
    prec = prec[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(prec.sum() / (prec.size * (1 - MIN_PRECISION)))


def _calc_tp(md: dict, metric: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    last = md["max_recall_ind"]
    if last < first:
        return 1.0
    e = md["errors"][metric][first:last + 1]
    return float(np.mean(e)) if e.size else 1.0


def nuscenes_style_eval(dets: List[dict], gts: List[dict],
                        class_names: Sequence[str],
                        ego_translations: Optional[List] = None,
                        filter_by_range: bool = True) -> dict:
    """dets/gts: per-sample dicts with boxes (K, >=7), labels (K,); dets
    additionally scores (K,) + optional mask + optional attrs (K,) str;
    gts optionally attrs / num_pts (lidar+radar point counts for the
    devkit zero-point filter). ``ego_translations``: per-sample (x, y[,z])
    of the ego in the box frame (defaults to the origin — exact when boxes
    are in the ego frame, ~1 m off in the lidar frame).

    Returns the devkit metric dict: per-class AP / TP errors, mAP, mATE,
    mASE, mAOE, mAVE, mAAE, NDS.
    """
    n = len(dets)
    egos = ego_translations or [np.zeros(2)] * n
    f_dets, f_gts = [], []
    for s in range(n):
        d = dets[s]
        boxes = np.asarray(d.get("bboxes", d.get("boxes")))
        scores = np.asarray(d["scores"])
        labels = np.asarray(d["labels"])
        attrs = d.get("attrs")
        if "mask" in d:
            m = np.asarray(d["mask"], bool)
            boxes, scores, labels = boxes[m], scores[m], labels[m]
            attrs = np.asarray(attrs)[m] if attrs is not None else None
        ego_xy = np.asarray(egos[s], np.float64)[:2]
        if filter_by_range:
            boxes, labels, scores, attrs = _filter_sample(
                boxes, labels, class_names, ego_xy, [scores, attrs])
        f_dets.append(dict(boxes=boxes, labels=labels, scores=scores,
                           attrs=attrs))
        g = gts[s]
        gboxes = np.asarray(g["boxes"])
        glabels = np.asarray(g["labels"])
        gattrs = g.get("attrs")
        if filter_by_range:
            gboxes, glabels, gattrs = _filter_sample(
                gboxes, glabels, class_names, ego_xy, [gattrs],
                num_pts=g.get("num_pts"))
        f_gts.append(dict(boxes=gboxes, labels=glabels, attrs=gattrs))

    metrics: dict = {}
    aps = []
    tp_errs: Dict[str, list] = {k: [] for k in TP_METRICS}
    attr_avail = any(g.get("attrs") is not None for g in f_gts)
    for ci, name in enumerate(class_names):
        cls_aps = []
        md_tp = None
        for th in DIST_THS:
            md = _accumulate(f_dets, f_gts, name, ci, th)
            if not md["valid"]:
                cls_aps.append(0.0 if md["npos"] > 0 else np.nan)
                continue
            cls_aps.append(_calc_ap(md))
            if th == TP_DIST_TH:
                md_tp = md
        if np.all(np.isnan(cls_aps)):
            continue  # class absent from GT entirely (devkit would raise)
        ap = float(np.nanmean(cls_aps))
        metrics[f"{name}_AP"] = ap
        aps.append(ap)
        for k in TP_METRICS:
            if k in LEAVE_OUT.get(name, ()):
                continue
            v = _calc_tp(md_tp, k) if md_tp is not None else 1.0
            metrics[f"{name}_{k}"] = v
            tp_errs[k].append(v)

    m_ap = float(np.mean(aps)) if aps else 0.0
    metrics["mAP"] = m_ap
    short = dict(trans_err="mATE", scale_err="mASE", orient_err="mAOE",
                 vel_err="mAVE", attr_err="mAAE")
    nds_sum = 5 * m_ap
    for k in TP_METRICS:
        v = float(np.mean(tp_errs[k])) if tp_errs[k] else 1.0
        if k == "attr_err" and not attr_avail:
            v = 0.0  # unavailable in the info pkls: flagged below
        metrics[short[k]] = v
        nds_sum += max(0.0, 1.0 - min(1.0, v))
    metrics["NDS"] = float(nds_sum / 10.0)
    metrics["attr_err_available"] = bool(attr_avail)
    return metrics
