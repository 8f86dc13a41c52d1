"""Host-side corpus abstractions: Video / Datasplit / Corpus / GroundTruth.

Same *behavioral* contract as the reference's data layer
(src/data/corpus.py, derived from slim_mallow) — feature/label
length-mismatch truncation with a 50-frame tolerance (corpus.py:17),
background removal, frame subsampling with repeat-expansion at eval
(corpus.py:335-346, :466-472), feature downscaling, diagnostic feature
permutation, and the per-task accuracy/F1 evaluation loop
(corpus.py:405-604) — but structured around a different design:

* a Video materializes a single immutable *frame plan* (reconciled
  length + kept-frame indices) instead of the reference's mutable
  lazy-invalidation state machine, and every accessor is a pure view
  through that plan;
* sample assembly (``Datasplit.__getitem__``) is a pipeline of small
  module-level functions producing the fixed-shape numpy batch inputs
  the models consume;
* label/component interning is a reusable ``_Interner``;
* the evaluation loop is decomposed into per-task helpers with the
  comparison-folder machinery isolated in ``_ComparisonPredictions``.

Quirks that are parity-load-bearing (return_stat overwritten per task,
the comparison-stat key set, gt2label capture order) are kept and
labeled inline.
"""

import json
import os

import numpy as np

from action_segmentation_torch.evaluation.accuracy import Accuracy
from action_segmentation_torch.evaluation.f1 import F1Score
from action_segmentation_torch.utils import logger, nested_dict_map

FEATURE_LABEL_MISMATCH_TOLERANCE = 50


class _FramePlan:
    """Immutable per-video frame bookkeeping, computed once.

    ``n_frames``: reconciled length (features vs labels, tolerance
    asserted); ``keep``: indices of retained (non-background) frames
    within [0, n_frames), or None when background is kept.
    """

    __slots__ = ("n_frames", "keep")

    def __init__(self, n_frames, keep):
        self.n_frames = n_frames
        self.keep = keep


def _reconcile_length(n_label_frames, n_feature_frames):
    """The reference's truncation rule (corpus.py:107-126): labels may
    run past features by at most the tolerance; the video is cut to the
    shorter of the two."""
    overhang = n_label_frames - n_feature_frames
    assert overhang <= FEATURE_LABEL_MISMATCH_TOLERANCE, (
        "len(gt_with_background) = {}, n_frames = {}".format(
            n_label_frames, n_feature_frames
        )
    )
    return min(n_label_frames, n_feature_frames)


class Video:
    """One video: a loading recipe plus a lazily-computed _FramePlan.

    All accessors (features / gt / gt_with_background / constraints)
    are pure functions of (raw inputs, plan); nothing is invalidated or
    recomputed-with-different-answers later.
    """

    def __init__(
        self,
        feature_root,
        K,
        remove_background,
        *,
        nonbackground_timesteps=None,
        gt=None,
        gt_with_background=None,
        name="",
        cache_features=False,
        has_label=True,
        features_contain_background=True,
        constraints=None,
        feature_permutation_seed=None,
    ):
        assert name
        if remove_background:
            assert has_label
            assert nonbackground_timesteps is not None
            assert len(nonbackground_timesteps) == len(gt)
        self.name = name
        self._feature_root = feature_root
        self._K = K
        self._remove_background = remove_background
        self._nonbackground_timesteps = nonbackground_timesteps
        self._gt = [] if gt is None else gt
        self._gt_with_background = gt_with_background
        self._cache_features = cache_features
        self._has_label = has_label
        self._features_contain_background = features_contain_background
        self._constraints = constraints
        self._feature_permutation_seed = feature_permutation_seed
        self._plan = None
        self._cached_features = None

    def load_features(self):
        raise NotImplementedError("should be implemented by subclasses")

    @property
    def has_label(self):
        return self._has_label

    # ----- frame plan ---------------------------------------------------

    def _get_plan(self, raw_features=None):
        """Compute (once) the reconciled length + kept-frame indices.

        Needs one feature load to learn the raw frame count unless the
        caller already holds the raw array or the features exclude
        background frames (then the label stream defines the length,
        reference corpus.py:127-131).
        """
        if self._plan is not None:
            return self._plan
        if self._features_contain_background:
            if raw_features is None:
                raw_features = self.load_features()
            n = raw_features.shape[0]
            if self._has_label:
                n = _reconcile_length(len(self._gt_with_background), n)
        else:
            n = len(self._gt_with_background)
        keep = None
        if self._remove_background:
            keep = [t for t in self._nonbackground_timesteps if t < n]
        self._plan = _FramePlan(n, keep)
        return self._plan

    def n_frames(self):
        return None if self._plan is None else self._plan.n_frames

    def approx_n_frames(self):
        """Cheap length estimate (no feature IO) for batching sort keys;
        may exceed the true sample length by at most the feature/label
        mismatch tolerance (50 frames) before truncation applies."""
        if self._remove_background and self._nonbackground_timesteps is not None:
            return len(self._nonbackground_timesteps)
        if self._gt_with_background is not None:
            return len(self._gt_with_background)
        return 0 if self._plan is None else self._plan.n_frames

    # ----- views --------------------------------------------------------

    def features(self):
        if self._cached_features is not None:
            return self._apply_permutation(self._cached_features)
        raw = self.load_features()
        plan = self._get_plan(raw_features=raw)
        if self._features_contain_background:
            feats = raw[: plan.n_frames]
            if plan.keep is not None:
                feats = feats[plan.keep]
        else:
            # features were exported without background frames already;
            # the label stream is what gets cut (reference corpus.py:153-157)
            feats = raw
        if self._cache_features:
            self._cached_features = feats
        return self._apply_permutation(feats)

    def _apply_permutation(self, feats):
        if self._feature_permutation_seed is None:
            return feats
        # diagnostic column shuffle (reference corpus.py:88-97): seeded
        # per video, applied on every access
        state = np.random.RandomState(self._feature_permutation_seed)
        permutation = np.arange(feats.shape[1])
        state.shuffle(permutation)
        return feats[:, permutation]

    def gt(self):
        plan = self._get_plan()
        labels = self._gt_with_background if self._remove_background else self._gt
        cut = labels[: plan.n_frames]
        if plan.keep is None:
            return cut
        return [cut[ix] for ix in plan.keep]

    def gt_with_background(self):
        plan = self._get_plan()
        return self._gt_with_background[: plan.n_frames]

    @property
    def constraints(self):
        if self._constraints is None or not self._remove_background:
            return self._constraints
        plan = self._get_plan()
        return self._constraints[: plan.n_frames][plan.keep]


# ----- sample assembly (Datasplit.__getitem__ pipeline) -----------------


def _task_index_list(corpus, task_name, remove_background):
    indices = corpus.indices_by_task(task_name)
    if remove_background:
        indices = set(indices) - set(corpus._background_indices)
    return sorted(indices)


class Datasplit:
    """A set of Videos grouped by task + the evaluation loop.

    Subclasses implement _load_ground_truth_and_videos() to populate
    ``_videos_by_task`` / ``groundtruth`` / ``_K_by_task``.
    """

    def __init__(
        self,
        corpus,
        remove_background,
        full=True,
        subsample=1,
        feature_downscale=1.0,
        feature_permutation_seed=None,
    ):
        self._corpus = corpus
        self._remove_background = remove_background
        self._full = full
        self._feature_permutation_seed = feature_permutation_seed
        self.subsample = subsample
        self.feature_downscale = feature_downscale
        self.return_stat = {}
        self._videos_by_task = {}
        self._gt2label = None
        self._label2gt = {}
        self.groundtruth = None
        self._K_by_task = None
        self._load_ground_truth_and_videos(remove_background)
        assert self.groundtruth is not None
        assert len(self._videos_by_task) != 0
        assert self._K_by_task is not None
        self._tasks_and_video_names = sorted(
            (task_name, video_name)
            for task_name, vid_dict in self._videos_by_task.items()
            for video_name in vid_dict
        )
        self._tasks_by_video = {
            video_name: task_name
            for task_name, video_name in self._tasks_and_video_names
        }

    @property
    def corpus(self):
        return self._corpus

    @property
    def remove_background(self):
        return self._remove_background

    @property
    def videos_by_task(self):
        return self._videos_by_task

    def __len__(self):
        return len(self._tasks_and_video_names)

    def approx_length(self, task_and_video_name):
        """Cheap per-video length for length-sorted batching (no feature
        IO; relative order is what matters for bucketing)."""
        task_name, video_name = task_and_video_name
        return self._videos_by_task[task_name][video_name].approx_n_frames()

    def __getitem__(self, task_and_video_name):
        task_name, video_name = task_and_video_name
        video = self._videos_by_task[task_name][video_name]
        try:
            features = video.features()
        except Exception as e:
            # skip-and-continue mirrors the reference (corpus.py:320-325),
            # but at WARNING: a wrong --feature_root makes EVERY video
            # "missing", and that must be visible, not logger.debug-only
            logger.warning(
                "exception with task and video {}: {}".format(
                    task_and_video_name, e
                )
            )
            return None

        constraints = video.constraints
        gt_single = (
            np.asarray([gt_t[0] for gt_t in video.gt()], np.int64)
            if video.has_label
            else None
        )

        if constraints is not None:
            # align the constraint rows to the reconciled feature frames
            # BEFORE any subsampling: CrossTask narration matrices are
            # built at the annotation length (crosstask.py get_T /
            # read_assignment), which may overhang or undershoot the
            # feature count within the 50-frame mismatch tolerance. The
            # reference neither cut nor subsampled constraints
            # (corpus.py:333-355 + model.py:54-61 pad_sequence), so a
            # mismatched video crashes its log_likelihood on shape
            # grounds; truncating/zero-padding to the frame plan (zero
            # rows = no narration penalty) is the fix-forward that keeps
            # every row aligned with its frame.
            constraints = np.asarray(constraints, np.float32)
            n_feat = features.shape[0]
            if constraints.shape[0] > n_feat:
                constraints = constraints[:n_feat]
            elif constraints.shape[0] < n_feat:
                constraints = np.concatenate(
                    [
                        constraints,
                        np.zeros(
                            (n_feat - constraints.shape[0], constraints.shape[1]),
                            np.float32,
                        ),
                    ]
                )

        if self.subsample != 1:
            # ONE index set derived from the feature count subsamples
            # features, labels, and constraints (reference
            # corpus.py:335-341 — arange(T // s) * s off
            # features.shape[0]) so the streams stay frame-aligned even
            # when their pre-subsample lengths differ (PCA exports with
            # features_contain_background=False leave gt at the
            # label-derived length while features keep the export
            # count; subsampling gt by ITS OWN length would then yield
            # a different frame count and crash collate)
            idx = (
                np.arange(features.shape[0] // self.subsample)
                * self.subsample
            )
            features = features[idx]
            gt_sampled = gt_single[idx] if gt_single is not None else None
            if constraints is not None:
                constraints = constraints[idx]
        else:
            # same frame-plan alignment as the subsample path: gt built
            # at the label-derived length can overhang the reconciled
            # feature count (features_contain_background=False exports);
            # cut to the feature count so collate's dense copy lines up
            gt_sampled = (
                gt_single[: features.shape[0]]
                if gt_single is not None
                else None
            )

        if self.feature_downscale != 1.0:
            features = features / self.feature_downscale

        sample = {
            "task_name": task_name,
            "video_name": video_name,
            "features": np.asarray(features, np.float32),
            "task_indices": np.asarray(
                _task_index_list(self.corpus, task_name, self.remove_background),
                np.int64,
            ),
        }
        if constraints is not None:
            sample["constraints"] = np.asarray(constraints, np.float32)
        if video.has_label:
            sample["gt"] = video.gt()
            sample["gt_single_unsampled"] = gt_single
            sample["gt_single"] = np.asarray(gt_sampled, np.int64)
            sample["gt_with_background"] = video.gt_with_background()
        return sample

    def _get_by_index(self, index):
        return self.__getitem__(self._tasks_and_video_names[index])

    @property
    def feature_dim(self):
        # the first videos can be unloadable (skipped with a warning);
        # probe until one loads instead of subscripting None
        for i in range(len(self)):
            sample = self._get_by_index(i)
            if sample is not None:
                return sample["features"].shape[1]
        raise RuntimeError(
            "feature_dim: no loadable videos in this datasplit — is the "
            "feature root correct?"
        )

    def _load_ground_truth_and_videos(self, remove_background):
        raise NotImplementedError("subclasses should implement")

    def get_allowed_starts_and_transitions(self):
        raise NotImplementedError("subclasses should implement")

    def get_ordered_indices_no_background(self):
        raise NotImplementedError("subclasses should implement")

    def canonicalize_background(self, index):
        backgrounds = self._corpus._background_indices
        return backgrounds[0] if index in backgrounds else index

    # ----- evaluation loop ---------------------------------------------

    def accuracy_corpus(
        self,
        optimal_assignment,
        prediction_function,
        prefix="",
        verbose=True,
        compare_to_folder=None,
    ):
        """Per-task Accuracy + F1 evaluation (reference corpus.py:405-604)."""
        stats_by_task = {}
        comparison = (
            _ComparisonPredictions(compare_to_folder)
            if compare_to_folder is not None
            else None
        )
        for task in self._videos_by_task:
            if verbose:
                logger.debug("computing accuracy for task {}".format(task))
            stats_by_task[task] = self._evaluate_task(
                task, optimal_assignment, prediction_function, prefix,
                verbose, comparison,
            )
        return stats_by_task

    def _evaluate_task(
        self, task, optimal_assignment, prediction_function, prefix, verbose,
        comparison,
    ):
        videos = self._videos_by_task[task]
        accuracy = Accuracy(verbose=verbose, corpus=self._corpus)
        f1_score = F1Score(
            K=self._K_by_task[task], n_videos=len(videos), verbose=verbose
        )
        if prediction_function is not None:
            for video_name, video in videos.items():
                gt, pred = self._model_gt_and_pred(video, prediction_function)
                accuracy.add_gt_labels(gt)
                accuracy.add_predicted_labels(pred)

        compare_accuracy = None
        if comparison is not None:
            compare_accuracy = Accuracy(verbose=verbose, corpus=self._corpus)
            comparison.accumulate(task, videos, compare_accuracy)

        named_accuracies = []
        if prediction_function is not None:
            named_accuracies.append(("model", accuracy))
            accuracy_to_return = accuracy
        else:
            assert compare_accuracy is not None, (
                "accuracy_corpus needs a prediction_function or a "
                "compare_to_folder — with neither there is nothing to score"
            )
            accuracy_to_return = compare_accuracy
        if comparison is not None:
            named_accuracies.append(
                ("comparison: {}".format(comparison.folder), compare_accuracy)
            )

        for acc_name, acc in named_accuracies:
            acc.mof(
                optimal_assignment,
                possible_gt_labels=self.corpus.indices_by_task(task),
            )
            if acc_name == "model":
                # the Hungarian gt->cluster map feeds F1 and the
                # per-class prediction export (reference corpus.py:528-541)
                self._gt2label = acc._gt2cluster
                self._label2gt = {
                    val[0]: key
                    for key, val in self._gt2label.items()
                    if len(val)
                }
            if verbose:
                logger.debug("%s Task: %s" % (prefix, task))
                logger.debug("%s MoF val: " % prefix + str(acc.mof_val()))
            acc.mof_classes()
            acc.iou_classes()
            acc.levenshtein()
            acc.single_step_recall()

        # QUIRK (reference corpus.py:569): return_stat is overwritten
        # every task — after the loop it holds the LAST task's stats
        self.return_stat = accuracy_to_return.stat()

        if prediction_function is not None:
            # the accumulator's cached flats ARE long_gt's first labels /
            # long_pr in the same per-video order (reference
            # corpus.py:528-541 rebuilt both as Python lists)
            f1_score.set_gt_single(accuracy.gt_labels)
            f1_score.set_pr(accuracy.predicted_labels)
            f1_score.set_gt2pr(self._gt2label)
            f1_score.f1()
            for key, val in f1_score.stat().items():
                self.return_stat[key] = val

        # SUBTLE (reference corpus.py:586-603): stat() returns the
        # accumulator's OWN dict, so attaching num_videos and the
        # comparison_* keys here mutates the very dict the final stat()
        # call returns — and the F1 keys written into return_stat above
        # land there too. The mutation order is parity-load-bearing.
        stats = accuracy_to_return.stat()
        stats["num_videos"] = np.array([len(videos), 1])
        if comparison is not None:
            comparison_stats = compare_accuracy.stat()
            for k in (
                "mof",
                "mof_bg",
                "mof_non_bg",
                "step_recall_non_bg",
                "mean_normed_levenshtein",
                "f1",
                "f1_non_bg",
                "pred_background",
            ):
                stats["comparison_{}".format(k)] = comparison_stats[k]
            # QUIRK (reference corpus.py:599): the reference fills the
            # center-step header from the PLAIN step recall — preserved
            # verbatim so comparison rows match its outputs
            stats["comparison_center_step_recall_non_bg"] = comparison_stats[
                "step_recall_non_bg"
            ]
        return accuracy_to_return.stat()

    def _model_gt_and_pred(self, video, prediction_function):
        """One video's (gt, pred) label streams for the model accuracy:
        repeat-expand subsampled predictions back to full rate
        (reference corpus.py:466-472) and canonicalize multi-background
        labels when the corpus annotates background with the preceding
        step."""
        gt = list(video.gt())
        pred = list(prediction_function(video))
        if self.subsample != 1:
            pred = list(
                np.array(pred + [pred[-1]]).repeat(self.subsample)[: len(gt)]
            )
            assert len(gt) == len(pred)
        if self.corpus.annotate_background_with_previous:
            gt = [
                [self.canonicalize_background(ix) for ix in gt_t]
                for gt_t in gt
            ]
            pred = [self.canonicalize_background(ix) for ix in pred]
        return gt, pred


class _ComparisonPredictions:
    """Loads a prior run's exported predictions (--compare_load_splits)
    and scores them through the same Accuracy machinery.

    Supports all three export layouts: one y_true/y_pred JSON pair for
    the whole corpus, per-video .npy pairs, or per-video JSON files.
    """

    def __init__(self, folder):
        self.folder = folder
        self._y_true = self._y_pred = None
        bulk = os.path.join(folder, "y_true.json")
        if os.path.exists(bulk):
            with open(bulk) as f:
                self._y_true = json.load(f)
            with open(os.path.join(folder, "y_pred.json")) as f:
                self._y_pred = json.load(f)

    def load(self, task, video_name):
        if self._y_true is not None:
            return (
                np.array(self._y_true[str(task)][video_name]),
                np.array(self._y_pred[str(task)][video_name]),
            )
        npy = os.path.join(self.folder, "{}_y_true.npy".format(video_name))
        if os.path.exists(npy):
            return (
                np.load(npy),
                np.load(
                    os.path.join(self.folder, "{}_y_pred.npy".format(video_name))
                ),
            )
        with open(os.path.join(self.folder, "{}.json".format(video_name))) as f:
            data = {k: np.array(v) for k, v in json.load(f).items()}
        return data["y_true"], data["y_pred"]

    def accumulate(self, task, videos, compare_accuracy):
        """Two passes, as in the reference (corpus.py:499-527): first
        build the exported-index -> gt-label mapping from every video's
        y_true one-hots (asserting consistency), then feed the mapped
        streams into the comparison Accuracy."""
        task_mapping = {}
        for video_name, video in videos.items():
            trues = self.load(task, video_name)[0].argmax(axis=1)
            gts = video.gt()
            assert len(trues) == len(gts)
            for t, gt_t in zip(trues, gts):
                seen = task_mapping.setdefault(t, gt_t[0])
                assert seen == gt_t[0]
        for video_name, video in videos.items():
            y_true, y_pred = self.load(task, video_name)
            trues = y_true.argmax(axis=1)
            preds = y_pred.argmax(axis=1)
            compare_accuracy.add_gt_labels([[task_mapping[t]] for t in trues])
            compare_accuracy.add_predicted_labels(
                [task_mapping[p] for p in preds]
            )


# ----- corpus-level label bookkeeping -----------------------------------


class _Interner:
    """Order-preserving label -> dense index interner with a freeze
    switch (new labels are an error once the corpus is built)."""

    def __init__(self):
        self.to_index = {}
        self.to_label = {}
        self.frozen = False

    def __len__(self):
        return len(self.to_index)

    def intern(self, label):
        index = self.to_index.get(label)
        if index is None:
            assert not self.frozen, "indexing {} after freeze".format(label)
            index = len(self.to_index)
            self.to_index[label] = index
            self.to_label[index] = label
        return index


class Corpus:
    def __init__(self, background_labels, cache_features=False):
        self._labels = _Interner()
        self._components = _Interner()
        self.label_indices2component_indices = {}
        self._cache_features = cache_features
        self._background_labels = background_labels
        self._background_indices = [
            self._index(label) for label in background_labels
        ]
        self._indices_by_task = {}
        self._load_mapping()
        self._labels.frozen = True
        self._components.frozen = True

    # dict views kept name-compatible with the wide consumer surface
    @property
    def label2index(self):
        return self._labels.to_index

    @property
    def index2label(self):
        return self._labels.to_label

    @property
    def component2index(self):
        return self._components.to_index

    @property
    def index2component(self):
        return self._components.to_label

    @property
    def n_classes(self):
        return len(self._labels)

    @property
    def n_components(self):
        return len(self._components)

    @property
    def _labels_frozen(self):
        return self._labels.frozen

    def _index(self, label):
        known = label in self._labels.to_index
        label_idx = self._labels.intern(label)
        if not known:
            self.label_indices2component_indices[label_idx] = sorted(
                self._components.intern(component)
                for component in self._get_components_for_label(label)
            )
        return label_idx

    def _index_component(self, component_label):
        return self._components.intern(component_label)

    def _get_components_for_label(self, label):
        raise NotImplementedError()

    def indices_by_task(self, task):
        return sorted(self._indices_by_task[task])

    def update_indices_by_task(self, task, indices):
        self._indices_by_task.setdefault(task, set()).update(indices)

    def _load_mapping(self):
        raise NotImplementedError("subclasses should implement")

    def get_datasplit(self, remove_background, full=True):
        raise NotImplementedError("subclasses should implement")


# ----- ground truth -----------------------------------------------------


def _nonbackground_steps(gt, background_indices):
    """Frame indices whose FIRST label is not background (multi-label
    frames count as background only via their first label — reference
    corpus.py:556-558)."""
    return [t for t, gt_t in enumerate(gt) if gt_t[0] not in background_indices]


class GroundTruth:
    def __init__(self, corpus, task_names, remove_background):
        self._corpus = corpus
        self._task_names = task_names
        self._remove_background = remove_background
        self.gt_by_task = {}
        self.gt_with_background_by_task = {}
        self.order_by_task = {}
        self.order_with_background_by_task = {}
        self.nonbackground_timesteps_by_task = {}
        self.load_gt_and_remove_background()

    def _load_gt(self):
        raise NotImplementedError("_load_gt")

    def load_gt_and_remove_background(self):
        self._load_gt()
        self.gt_with_background_by_task = self.gt_by_task
        self.order_with_background_by_task = self.order_by_task
        if self._remove_background:
            self.remove_background()
        for task, gt_dict in self.gt_by_task.items():
            label_set = set()
            for gt in gt_dict.values():
                for gt_t in gt:
                    label_set.update(gt_t)
            self._corpus.update_indices_by_task(task, label_set)

    def remove_background(self):
        """Split the label streams into with/without-background views:
        the full streams are preserved under *_with_background, and the
        primary views keep only non-background frames."""
        # structured two-level copy (cheaper than deepcopy; the leaf
        # label lists are shared read-only)
        self.gt_with_background_by_task = nested_dict_map(
            self.gt_by_task, lambda task, video, gt: list(gt)
        )
        self.order_with_background_by_task = nested_dict_map(
            self.order_by_task, lambda task, video, order: list(order)
        )
        background = set(self._corpus._background_indices)

        self.nonbackground_timesteps_by_task = nested_dict_map(
            self.gt_by_task,
            lambda task, video, gt: _nonbackground_steps(gt, background),
        )

        def keep_nonbackground(task, video, gt):
            kept_ix = set(self.nonbackground_timesteps_by_task[task][video])
            kept = [val for ix, val in enumerate(gt) if ix in kept_ix]
            # per-frame leak check: gt entries are per-frame label
            # LISTS, so the reference's `ix in gt` form (corpus.py:791)
            # compares an int against lists and can never fire
            assert background.isdisjoint(
                {label for val in kept for label in val}
            ), "background frames survived remove_background"
            return kept

        self.gt_by_task = nested_dict_map(self.gt_by_task, keep_nonbackground)
        self.order_by_task = nested_dict_map(
            self.order_by_task,
            lambda task, video, order: [
                t for t in order if t[0] not in background
            ],
        )
