"""ScanNet instance-segmentation AP protocol (host, numpy).

Same protocol as the public ScanNet benchmark script, which the reference
vendors as util/eval.py:42-402: greedy confidence matching per (class,
overlap) with void/group handling, AP via the step-integrated PR curve,
mAP over overlaps 0.5:0.95:0.05 plus AP@0.25, min region 100 verts.
GT encoding: gt_id = semantic_label * 1000 + instance_index + 1.

Parameterized by fold (the reference hard-wires cfg.cvfold at import,
eval.py:32-33) and supports multi-run mean±std aggregation for the
few-shot protocol (eval.py:241-287).

The port's copy of geoformer_tpu/evaluation/scannet_eval.py
(host code, kept name for name): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

CLASS_LABELS_FOLD0 = ["cabinet", "bed", "chair", "door", "bookshelf", "counter", "desk", "curtain", "bathtub"]
VALID_CLASS_IDS_FOLD0 = np.array([3, 4, 5, 8, 10, 12, 14, 16, 36])

CLASS_LABELS_FOLD1 = [
    "sofa", "table", "window", "picture", "refrigerator", "shower curtain",
    "toilet", "sink", "otherfurniture",
]
VALID_CLASS_IDS_FOLD1 = np.array([6, 7, 9, 11, 24, 28, 33, 34, 39])

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


class ScanNetEval:
    def __init__(self, cvfold: int = 0):
        if cvfold == 1:
            self.class_labels = CLASS_LABELS_FOLD1
            self.valid_class_ids = VALID_CLASS_IDS_FOLD1
        else:
            self.class_labels = CLASS_LABELS_FOLD0
            self.valid_class_ids = VALID_CLASS_IDS_FOLD0
        self.id_to_label = dict(zip(self.valid_class_ids, self.class_labels))
        self.matches: dict = {}

    # ---------------- per-scene association ----------------

    def _gt_instances(self, gt_ids):
        """gt_ids [N] = sem*1000 + inst + 1. Returns per-class instance lists."""
        out = {label: [] for label in self.class_labels}
        for inst_id in np.unique(gt_ids):
            label_id = inst_id // 1000
            if inst_id <= 0 or label_id not in self.id_to_label:
                continue
            sel = gt_ids == inst_id
            out[self.id_to_label[label_id]].append(
                {
                    "instance_id": int(inst_id),
                    "label_id": int(label_id),
                    "vert_count": int(sel.sum()),
                    "matched_pred": [],
                }
            )
        return out

    def assign_instances_for_scan(self, scene_name, pred_info, gt_ids):
        """pred_info: dict with label_id [M], conf [M], mask [M,N] (binary)."""
        gt2pred = self._gt_instances(gt_ids)
        pred2gt = {label: [] for label in self.class_labels}
        bool_void = ~np.isin(gt_ids // 1000, self.valid_class_ids)

        n_pred = 0
        for i in range(len(pred_info["label_id"])):
            label_id = int(pred_info["label_id"][i])
            if label_id not in self.id_to_label:
                continue
            mask = np.asarray(pred_info["mask"][i]) != 0
            num = int(mask.sum())
            if num < MIN_REGION_SIZE:
                continue
            label_name = self.id_to_label[label_id]
            pred = {
                "filename": f"{scene_name}_{n_pred:03d}",
                "label_id": label_id,
                "vert_count": num,
                "confidence": float(pred_info["conf"][i]),
                "void_intersection": int(np.logical_and(bool_void, mask).sum()),
                "matched_gt": [],
            }
            for gt in gt2pred[label_name]:
                inter = int(np.logical_and(gt_ids == gt["instance_id"], mask).sum())
                if inter > 0:
                    gt_copy = dict(gt, intersection=inter)
                    pred_copy = dict(pred, intersection=inter)
                    gt_copy.pop("matched_pred", None)
                    pred_copy.pop("matched_gt", None)
                    pred["matched_gt"].append(gt_copy)
                    gt["matched_pred"].append(pred_copy)
            n_pred += 1
            pred2gt[label_name].append(pred)

        self.matches[scene_name] = {"gt": gt2pred, "pred": pred2gt}

    def reset(self):
        self.matches = {}

    # ---------------- AP computation ----------------

    def evaluate_matches(self):
        matches = self.matches
        n_classes = len(self.class_labels)
        ap = np.zeros((n_classes, len(OVERLAPS)))
        for oi, overlap_th in enumerate(OVERLAPS):
            pred_visited = {
                p["filename"]: False
                for m in matches.values()
                for preds in m["pred"].values()
                for p in preds
            }
            for li, label_name in enumerate(self.class_labels):
                y_true, y_score = [], []
                hard_false_negatives = 0
                has_gt = has_pred = False
                for m in matches.values():
                    preds = m["pred"][label_name]
                    gts = [
                        g for g in m["gt"][label_name]
                        if g["instance_id"] >= 1000 and g["vert_count"] >= MIN_REGION_SIZE
                    ]
                    has_gt |= bool(gts)
                    has_pred |= bool(preds)

                    cur_true, cur_score, cur_match = [], [], []
                    for gt in gts:
                        found_match = False
                        this_score = -np.inf
                        for pred in gt["matched_pred"]:
                            if pred_visited[pred["filename"]]:
                                continue
                            overlap = pred["intersection"] / (
                                gt["vert_count"] + pred["vert_count"] - pred["intersection"]
                            )
                            if overlap > overlap_th:
                                conf = pred["confidence"]
                                if found_match:
                                    # duplicate: lower score becomes FP
                                    lo, hi = min(this_score, conf), max(this_score, conf)
                                    this_score = hi
                                    cur_true.append(0)
                                    cur_score.append(lo)
                                    cur_match.append(True)
                                else:
                                    found_match = True
                                    this_score = conf
                                    pred_visited[pred["filename"]] = True
                        if found_match:
                            cur_true.append(1)
                            cur_score.append(this_score)
                            cur_match.append(True)
                        else:
                            hard_false_negatives += 1

                    # unmatched predictions -> FP unless mostly void/ignored
                    for pred in preds:
                        found_gt = False
                        for gt in pred["matched_gt"]:
                            overlap = gt["intersection"] / (
                                gt["vert_count"] + pred["vert_count"] - gt["intersection"]
                            )
                            if overlap > overlap_th:
                                found_gt = True
                                break
                        if not found_gt:
                            num_ignore = pred["void_intersection"]
                            for gt in pred["matched_gt"]:
                                if gt["instance_id"] < 1000:
                                    num_ignore += gt["intersection"]
                                if gt["vert_count"] < MIN_REGION_SIZE:
                                    num_ignore += gt["intersection"]
                            if num_ignore / pred["vert_count"] <= overlap_th:
                                cur_true.append(0)
                                cur_score.append(pred["confidence"])
                                cur_match.append(True)

                    y_true.extend(cur_true)
                    y_score.extend(cur_score)

                if has_gt and has_pred:
                    ap[li, oi] = self._average_precision(
                        np.asarray(y_true, float), np.asarray(y_score, float),
                        hard_false_negatives,
                    )
                elif has_gt:
                    ap[li, oi] = 0.0
                else:
                    ap[li, oi] = np.nan
        return ap

    @staticmethod
    def _average_precision(y_true, y_score, hard_false_negatives):
        order = np.argsort(y_score)
        y_score, y_true = y_score[order], y_true[order]
        cumsum = np.cumsum(y_true)
        thresholds, unique_idx = np.unique(y_score, return_index=True)
        n = len(y_score)
        n_true = cumsum[-1] if len(cumsum) else 0
        num_pr = len(unique_idx) + 1
        precision = np.zeros(num_pr)
        recall = np.zeros(num_pr)
        cumsum_pad = np.append(cumsum, 0)
        for res_i, score_i in enumerate(unique_idx):
            c = cumsum_pad[score_i - 1]
            tp = n_true - c
            fp = n - score_i - tp
            fn = c + hard_false_negatives
            precision[res_i] = tp / (tp + fp)
            recall[res_i] = tp / (tp + fn)
        precision[-1] = 1.0
        recall[-1] = 0.0
        r_conv = np.concatenate([[recall[0]], recall, [0.0]])
        step_widths = np.convolve(r_conv, [-0.5, 0, 0.5], "valid")
        return float(np.dot(precision, step_widths))

    def compute_averages(self, ap=None):
        if ap is None:
            ap = self.evaluate_matches()
        o50 = np.isclose(OVERLAPS, 0.5)
        o25 = np.isclose(OVERLAPS, 0.25)
        not25 = ~o25
        avgs = {
            "all_ap": float(np.nanmean(ap[:, not25])),
            "all_ap_50%": float(np.nanmean(ap[:, o50])),
            "all_ap_25%": float(np.nanmean(ap[:, o25])),
            "classes": {},
        }
        for li, label in enumerate(self.class_labels):
            avgs["classes"][label] = {
                "ap": float(np.mean(ap[li, not25])),
                "ap50%": float(np.mean(ap[li, o50])),
                "ap25%": float(np.mean(ap[li, o25])),
            }
        return avgs


def average_over_runs(per_run_avgs: list[dict]) -> dict:
    """Few-shot multi-run mean±std (eval.py:264-287)."""
    out = {
        "all_ap": float(np.mean([a["all_ap"] for a in per_run_avgs])),
        "all_ap_50%": float(np.mean([a["all_ap_50%"] for a in per_run_avgs])),
        "all_ap_25%": float(np.mean([a["all_ap_25%"] for a in per_run_avgs])),
        "all_ap_std": float(np.std([a["all_ap"] for a in per_run_avgs])),
        "all_ap_50%_std": float(np.std([a["all_ap_50%"] for a in per_run_avgs])),
        "all_ap_25%_std": float(np.std([a["all_ap_25%"] for a in per_run_avgs])),
        "classes": {},
    }
    for label in per_run_avgs[0]["classes"]:
        out["classes"][label] = {
            k: float(np.mean([a["classes"][label][k] for a in per_run_avgs]))
            for k in ("ap", "ap50%", "ap25%")
        }
    return out


def print_results(avgs, logger):
    """Formatted AP table (eval.py:358-401)."""
    line_len = 64
    logger.info("")
    logger.info("#" * line_len)
    logger.info("{:<15}:{:>15}{:>15}{:>15}".format("what", "AP", "AP_50%", "AP_25%"))
    logger.info("#" * line_len)
    for label, c in avgs["classes"].items():
        logger.info(
            "{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(label, c["ap"], c["ap50%"], c["ap25%"])
        )
    logger.info("-" * line_len)
    logger.info(
        "{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
            "average", avgs["all_ap"], avgs["all_ap_50%"], avgs["all_ap_25%"]
        )
    )
    if "all_ap_std" in avgs:
        logger.info(
            "{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
                "std", avgs["all_ap_std"], avgs["all_ap_50%_std"], avgs["all_ap_25%_std"]
            )
        )
    logger.info("")
