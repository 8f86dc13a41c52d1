"""Hungarian-matched segmentation metrics.

Numpy re-implementation of the reference's Accuracy class
(src/evaluation/accuracy.py:39-705, itself derived from slim_mallow):
frame-level MoF / IoU with optional Hungarian correspondence between
predicted and ground-truth label spaces, multi-label-aware precision /
recall / F1, background statistics, segment-level Levenshtein on RLE
sequences, and sampled single-step recall. Every metric is reported as a
(numerator, denominator) pair so callers can aggregate across tasks
before dividing (reference main.py:486-521).
"""

from collections import defaultdict

import numpy as np
from scipy.optimize import linear_sum_assignment

from action_segmentation_torch.evaluation import editdistance
from action_segmentation_torch.utils import logger


def singleton_lookup(dictionary, label):
    assert label in dictionary, "{} not in {}".format(label, dictionary)
    values = dictionary[label]
    assert len(values) == 1
    return next(iter(values))


def run_length_encode(labels):
    """[(label, count), ...] over a flat label sequence (accuracy.py:21-37)."""
    arr = np.asarray(labels)
    if arr.size == 0:
        return []
    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    bounds = np.concatenate([[0], change, [len(arr)]])
    starts = bounds[:-1]
    return list(zip(arr[starts].tolist(), np.diff(bounds).tolist()))


class Accuracy:
    """Accumulates per-video gt (possibly multi-label per frame) and
    predictions, then computes correspondence-matched metrics."""

    def __init__(self, n_frames=1, verbose=True, corpus=None):
        self._n_frames = n_frames
        self._verbose = verbose
        self._corpus = corpus

        self._gt2cluster = defaultdict(list)
        # (the reference's `exclude` machinery, accuracy.py:266-276 and
        # 497-518, is only reachable from commented-out code there and
        # is deliberately not carried over)

        self._predicted_labels_per_video = []
        self._predicted_rle_per_video = []
        self._gt_labels_per_video = []
        # ragged multi-label gt as (counts, flat) per video: one Python
        # pass over the list-of-lists at add time; every later consumer
        # works on concatenated arrays (the reference re-flattens
        # per-frame Python lists inside each metric — at per-epoch
        # evaluation scale those repeated O(frames) Python passes were
        # most of the mof cost, scripts/metric_scale_check.py)
        self._gt_counts_per_video = []
        self._gt_flat_per_video = []
        self._gt_rle_per_video = []
        self._flat_cache = {}

        self._frames_true_pr = 0.0
        self._frames_overall = 0
        self._classes_MoF = {}
        self._classes_IoU = {}
        self._return = {}

    # ----- accumulation -----

    def add_gt_labels(self, labels):
        assert isinstance(labels, list) and isinstance(labels[0], list)
        n = len(labels)
        counts = np.fromiter((len(l) for l in labels), np.int64, n)
        flat = np.fromiter(
            (g for l in labels for g in l), np.int64, int(counts.sum())
        )
        starts = np.cumsum(counts) - counts
        singles = flat[starts]
        self._gt_labels_per_video.append(singles)
        self._gt_counts_per_video.append(counts)
        self._gt_flat_per_video.append(flat)
        self._gt_rle_per_video.append(run_length_encode(singles))
        self._flat_cache.clear()

    def add_predicted_labels(self, labels):
        labels = np.asarray(labels, np.int64)
        self._predicted_labels_per_video.append(labels)
        self._predicted_rle_per_video.append(run_length_encode(labels))
        self._flat_cache.clear()

    def _concat(self, key, parts):
        if key not in self._flat_cache:
            self._flat_cache[key] = (
                np.concatenate(parts) if parts else np.array([], np.int64)
            )
        return self._flat_cache[key]

    @property
    def gt_labels(self):
        return self._concat("gt", self._gt_labels_per_video)

    @property
    def predicted_labels(self):
        return self._concat("pr", self._predicted_labels_per_video)

    # ----- correspondence -----

    def _create_voting_table(self, gt_labels, predicted_labels):
        """Paired-assignment score table with synthetic padding labels when
        the label sets have different sizes (accuracy.py:232-283)."""
        uniq_gt = list(np.unique(gt_labels))
        uniq_pr = list(np.unique(predicted_labels))
        size = max(len(uniq_gt), len(uniq_pr))
        gt_label2index, gt_index2label = {}, {}
        for idx, lab in enumerate(uniq_gt):
            gt_label2index[lab] = idx
            gt_index2label[idx] = lab
        for idx in range(len(uniq_gt), size):
            lab = idx
            while lab in gt_label2index:
                lab += 1
            gt_label2index[lab] = idx
            gt_index2label[idx] = lab
        pr_label2index, pr_index2label = {}, {}
        for idx, lab in enumerate(uniq_pr):
            pr_label2index[lab] = idx
            pr_index2label[idx] = lab
        for idx in range(len(uniq_pr), size):
            lab = idx
            while lab in pr_label2index:
                lab += 1
            pr_label2index[lab] = idx
            pr_index2label[idx] = lab

        table = np.zeros((size, size))
        for idx_gt, gt_label in enumerate(uniq_gt):
            gt_mask = gt_labels == gt_label
            for idx_pr, pr_label in enumerate(uniq_pr):
                table[idx_gt, idx_pr] = np.sum(
                    predicted_labels[gt_mask] == pr_label, dtype=float
                )
        return table, gt_index2label, pr_index2label

    def _create_correspondences(self, optimal_assignment):
        gt_labels = self.gt_labels
        predicted_labels = self.predicted_labels
        if optimal_assignment:
            table, gt_i2l, pr_i2l = self._create_voting_table(
                gt_labels, predicted_labels
            )
            x, y = linear_sum_assignment(-table)
            for idx_gt, idx_pr in zip(x, y):
                self._gt2cluster[gt_i2l[idx_gt]] = [pr_i2l[idx_pr]]
        else:
            for label in np.unique(gt_labels):
                self._gt2cluster[label] = [label]

    def compute_assignment(self, optimal_assignment, possible_gt_labels=None):
        self._create_correspondences(optimal_assignment)
        if possible_gt_labels is None:
            possible_gt_labels = np.unique(self.gt_labels)
        num_gt = len(possible_gt_labels)
        num_pr = len(np.unique(self.predicted_labels))
        assert num_pr <= num_gt, "gt_labels: {}, pred_labels: {}".format(
            possible_gt_labels, np.unique(self.predicted_labels)
        )
        if self._verbose:
            logger.debug(
                "# gt_labels: %d   # pr_labels: %d" % (num_gt, num_pr)
            )

    def _cluster_of(self, gt_label):
        """Representative predicted label for a gt label, or None."""
        vals = self._gt2cluster[gt_label]
        return vals[0] if len(vals) > 0 else None

    # ----- frame-level metrics -----

    def mof(self, optimal_assignment, possible_gt_labels=None):
        """Frame accuracy machinery; returns total frame count
        (accuracy.py:475-579)."""
        self.compute_assignment(optimal_assignment, possible_gt_labels)
        gt_labels = self.gt_labels
        pred = self.predicted_labels

        background_clusters = set(
            self._cluster_of(label)
            for label in self._corpus._background_indices
            if len(self._gt2cluster[label]) > 0
        )

        self._classes_MoF = {}
        self._classes_IoU = {}
        self._frames_true_pr = 0.0
        for gt_label in np.unique(gt_labels):
            gt_mask = gt_labels == gt_label
            true_defined = 0.0
            union = 0
            for cluster in self._gt2cluster[gt_label]:
                true_defined += np.sum(pred[gt_mask] == cluster, dtype=float)
                pr_mask = pred == cluster
                union += np.sum(gt_mask | pr_mask)
            self._classes_MoF[gt_label] = [true_defined, np.sum(gt_mask)]
            self._classes_IoU[gt_label] = [true_defined, union]
            self._frames_true_pr += true_defined

        self._precision = np.zeros(2)
        self._recall = np.zeros(2)
        self._precision_without_bg = np.zeros(2)
        self._recall_without_bg = np.zeros(2)
        self._true_background_frames = np.zeros(2)
        self._pred_background_frames = np.zeros(2)
        self._non_bg_IoU_multi = np.zeros(2)
        self._multiple_labels = np.zeros(2)

        # Vectorized per-frame accumulation. The reference iterates the
        # corpus frame-by-frame in Python (accuracy.py:475-579) — ~10 s
        # per 1e6 frames, which would dwarf the device decode at
        # per-epoch evaluation scale (scripts/metric_scale_check.py).
        # Semantics are bit-identical: the ragged multi-label lists
        # (stored as (counts, flat) arrays at add time) pad into an
        # (N, Lmax) matrix and every membership test becomes an array
        # lookup.
        bkg_set = set(self._corpus._background_indices)
        N = len(pred)
        pred = np.asarray(pred)
        counts = self._concat("gt_counts", self._gt_counts_per_video)
        flat = self._concat("gt_flat", self._gt_flat_per_video)
        assert counts.size == N
        total_labels = int(counts.sum())
        Lmax = int(counts.max()) if N else 1
        mat = np.full((N, Lmax), -1, np.int64)
        rows = np.repeat(np.arange(N), counts)
        cols = np.arange(total_labels) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        mat[rows, cols] = flat
        valid = mat >= 0

        n_labels = int(max(flat.max(initial=0), max(bkg_set, default=0))) + 1
        SENTINEL = -(1 << 60)
        cluster_arr = np.full(n_labels, SENTINEL, np.int64)
        for label, vals in self._gt2cluster.items():
            if 0 <= label < n_labels and len(vals) > 0:
                cluster_arr[label] = vals[0]
        is_bkg_label = np.zeros(n_labels, bool)
        is_bkg_label[list(bkg_set)] = True

        clusters = np.where(valid, cluster_arr[np.maximum(mat, 0)], SENTINEL)
        tp = np.any(clusters == pred[:, None], axis=1)  # None clusters
        # never match: SENTINEL is outside the label space
        any_bg = np.any(valid & is_bkg_label[np.maximum(mat, 0)], axis=1)
        all_bg = np.all(~valid | is_bkg_label[np.maximum(mat, 0)], axis=1)
        # tripwire: corpus construction assigns background only to
        # frames NO step covers, so a frame can never mix background
        # and step labels; the vectorized mof relies on that, so fail
        # loudly if a future loader breaks it rather than mis-score
        assert np.all(~any_bg | all_bg), (
            "gt frame mixes background and step labels — vectorized mof "
            "assumes all-or-none background per frame"
        )
        pred_bg = (
            np.isin(pred, list(background_clusters))
            if background_clusters
            else np.zeros(N, bool)
        )

        non_bg_frame = ~any_bg
        iou_multi_den = non_bg_frame | ~pred_bg
        self._multiple_labels = np.array([float((counts > 1).sum()), float(N)])
        self._recall = np.array([float(tp.sum()), float(total_labels)])
        self._precision = np.array([float(tp.sum()), float(N)])
        self._true_background_frames = np.array([float(any_bg.sum()), float(N)])
        self._pred_background_frames = np.array([float(pred_bg.sum()), float(N)])
        self._non_bg_IoU_multi = np.array(
            [float((tp & iou_multi_den).sum()), float(iou_multi_den.sum())]
        )
        self._recall_without_bg = np.array(
            [float((tp & non_bg_frame).sum()), float(counts[non_bg_frame].sum())]
        )
        self._precision_without_bg = np.array(
            [float((tp & non_bg_frame).sum()), float(non_bg_frame.sum())]
        )

        self._frames_overall = len(gt_labels)
        return self._frames_overall

    def mof_classes(self):
        total_true = total = 0.0
        total_true_non_bkg = total_non_bkg = 0.0
        bkg_set = set(self._corpus._background_indices)
        for key, (true_frames, all_frames) in self._classes_MoF.items():
            if self._verbose:
                log_str = "mof label %d: %f  %d / %d" % (
                    key, true_frames / all_frames, true_frames, all_frames,
                )
                if self._corpus is not None:
                    log_str += "\t[{}]".format(self._corpus.index2label[key])
                logger.debug(log_str)
            total_true += true_frames
            total += all_frames
            if key not in bkg_set:
                total_true_non_bkg += true_frames
                total_non_bkg += all_frames

        self._return["mof"] = [self._frames_true_pr, self._frames_overall]
        self._return["mof_bg"] = [total_true, total]
        self._return["mof_non_bg"] = [total_true_non_bkg, total_non_bkg]
        self._return["precision"] = self._precision
        self._return["recall"] = self._recall

        precision = self._precision[0] / self._precision[1] if self._precision[1] else 0.0
        recall = self._recall[0] / self._recall[1] if self._recall[1] else 0.0
        f1 = (
            (2 * precision * recall) / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
        self._return["f1"] = np.array([f1, 1.0])

        self._return["precision_non_bg"] = self._precision_without_bg
        self._return["recall_non_bg"] = self._recall_without_bg
        p_nb = (
            self._precision_without_bg[0] / self._precision_without_bg[1]
            if self._precision_without_bg[1]
            else 0.0
        )
        r_nb = (
            self._recall_without_bg[0] / self._recall_without_bg[1]
            if self._recall_without_bg[1]
            else 0.0
        )
        f1_nb = (2 * p_nb * r_nb) / (p_nb + r_nb) if p_nb + r_nb > 0 else 0
        self._return["f1_non_bg"] = np.array([f1_nb, 1.0])

        self._return["true_background"] = self._true_background_frames
        self._return["pred_background"] = self._pred_background_frames
        self._return["iou_multi_non_bg"] = self._non_bg_IoU_multi
        self._return["multiple_gt_labels"] = self._multiple_labels

    def iou_classes(self):
        average_class_iou = 0.0
        for key, (true_frames, union) in self._classes_IoU.items():
            if self._verbose:
                logger.debug(
                    "iou label %d: %f  %d / %d" % (key, true_frames / union, true_frames, union)
                )
            average_class_iou += true_frames / union
        n = len(self._classes_IoU)
        self._return["iou"] = [average_class_iou, n]
        self._return["iou_bg"] = [average_class_iou, n]

    # ----- segment-level metrics -----

    def levenshtein(self, gt2cluster=None):
        if gt2cluster is None:
            gt2cluster = self._gt2cluster
        levenshteins = []
        max_num_segments = []
        predicted_segments = 0.0
        predicted_segments_non_bg = 0.0
        num_videos = 0
        background_remapped = set(
            singleton_lookup(gt2cluster, label)
            for label in self._corpus._background_indices
            if len(gt2cluster[label]) > 0
        )
        assert len(self._predicted_labels_per_video) == len(self._gt_labels_per_video)
        for gt_rle, pred_rle in zip(self._gt_rle_per_video, self._predicted_rle_per_video):
            num_videos += 1
            assert sum(l for _, l in gt_rle) == sum(l for _, l in pred_rle)
            gt_remapped = [singleton_lookup(gt2cluster, lab) for lab, _ in gt_rle]
            pred_segments = [lab for lab, _ in pred_rle]
            predicted_segments += len(pred_segments)
            predicted_segments_non_bg += len(
                [s for s in pred_segments if s not in background_remapped]
            )
            levenshteins.append(editdistance.eval(gt_remapped, pred_segments))
            max_num_segments.append(max(len(gt_remapped), len(pred_segments)))

        levenshteins = np.array(levenshteins, float)
        max_num_segments = np.array(max_num_segments, float)
        assert np.all(max_num_segments > 0)
        results = {
            "mean_levenshtein": np.array([np.mean(levenshteins), 1.0]),
            "mean_max_segments": np.array([np.mean(max_num_segments), 1.0]),
            "total_levenshtein": np.array([np.sum(levenshteins), 1.0]),
            "num_videos": np.array([len(levenshteins), 1.0]),
            "mean_normed_levenshtein": np.array(
                [np.mean(levenshteins / max_num_segments), 1.0]
            ),
            "predicted_segments_per_video": np.array([predicted_segments, num_videos]),
            "predicted_segments_non_bg_per_video": np.array(
                [predicted_segments_non_bg, num_videos]
            ),
        }
        self._return.update(results)

    def single_step_recall(self, gt2cluster=None):
        if gt2cluster is None:
            gt2cluster = self._gt2cluster
        step_match = step_total = 0.0
        nb_step_match = nb_step_total = 0.0
        center_step_match = nb_center_step_match = 0.0
        predicted_label_types = predicted_label_types_non_bg = 0.0
        num_videos = 0.0
        background_remapped = set(
            singleton_lookup(gt2cluster, label)
            for label in self._corpus._background_indices
            if len(gt2cluster[label]) > 0
        )
        for gt_labels, pred_labels in zip(
            self._gt_labels_per_video, self._predicted_labels_per_video
        ):
            num_videos += 1
            pred_labels = np.asarray(pred_labels)
            # remap through the PASSED mapping (reference accuracy.py:435)
            # — callers may re-score under a different correspondence.
            # Remap the few unique labels and scatter (the reference's
            # per-frame list comprehension is ~2 s per 1e6 frames).
            gt_arr = np.asarray(gt_labels)
            uniq, inv = np.unique(gt_arr, return_inverse=True)
            uniq_remapped = [
                gt2cluster[g][0] if len(gt2cluster[g]) > 0 else None
                for g in uniq.tolist()
            ]
            gt_remapped = np.asarray(uniq_remapped)[inv]
            # group predicted frame indices per label with ONE stable
            # argsort (equal keys keep their original order, so each
            # group is already ascending) instead of a full-array
            # `pred == label` scan per label
            order = np.argsort(pred_labels, kind="stable")
            sorted_pred = pred_labels[order]
            uniq_p, starts_p = np.unique(sorted_pred, return_index=True)
            ends_p = np.append(starts_p[1:], len(sorted_pred))
            groups = {
                lab: order[s:e]
                for lab, s, e in zip(uniq_p.tolist(), starts_p, ends_p)
            }
            for label in uniq_p:
                predicted_label_types += 1
                if label not in background_remapped:
                    predicted_label_types_non_bg += 1
            _EMPTY = np.empty(0, np.int64)
            for label in np.unique(gt_remapped):
                step_total += 1
                non_bg = label not in background_remapped
                if non_bg:
                    nb_step_total += 1
                pred_indices = groups.get(label, _EMPTY)
                if len(pred_indices) == 0:
                    continue
                # same stream as the reference's np.random.choice:
                # legacy choice(a) draws exactly one randint(0, len(a))
                # (verified bit-identical); the direct call skips
                # choice's per-call argument validation
                pred_index = pred_indices[np.random.randint(0, len(pred_indices))]
                # argmin == the reference's min(key=|x - center|): both
                # take the first index on ties
                center = (pred_indices[0] + pred_indices[-1]) / 2
                center_index = pred_indices[np.argmin(np.abs(pred_indices - center))]
                if gt_remapped[pred_index] == label:
                    step_match += 1
                    if non_bg:
                        nb_step_match += 1
                if gt_remapped[center_index] == label:
                    center_step_match += 1
                    if non_bg:
                        nb_center_step_match += 1
        self._return.update(
            {
                "single_step_recall": np.array([step_match, step_total]),
                "step_recall_non_bg": np.array([nb_step_match, nb_step_total]),
                "center_step_recall": np.array([center_step_match, step_total]),
                "center_step_recall_non_bg": np.array(
                    [nb_center_step_match, nb_step_total]
                ),
                "predicted_label_types_per_video": np.array(
                    [predicted_label_types, num_videos]
                ),
                "predicted_label_types_non_bg_per_video": np.array(
                    [predicted_label_types_non_bg, num_videos]
                ),
            }
        )

    def mof_val(self):
        return float(self._frames_true_pr) / self._frames_overall

    def frames(self):
        return self._frames_true_pr

    def stat(self):
        return self._return
