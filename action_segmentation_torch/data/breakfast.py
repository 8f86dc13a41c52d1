"""Breakfast dataset loaders (port of src/data/breakfast.py).

4-fold participant splits (s1-s4), mapping.txt label index, per-camera
annotation parsing with the reference's 9-video blacklist for
feature/label length mismatches, fisher-vector features with the
first-row/column drop (breakfast.py:315-319), and the PCA CLI. Twin of
the JAX package's module; the PCA export runs on the card unless the
caller passes ``device="cpu"``.
"""

import os
import re
from collections import Counter

import numpy as np

from action_segmentation_torch.data.corpus import Corpus, Datasplit, GroundTruth, Video
from action_segmentation_torch.data.features import grouped_pca
from action_segmentation_torch.utils import all_equal, logger

MISMATCH_BLACKLIST = [
    ("P51_coffee", "webcam01"),
    ("P34_coffee", "cam01"),
    ("P34_juice", "cam01"),
    ("P52_sandwich", "stereo01"),
    ("P54_scrambledegg", "webcam01"),
    ("P34_scrambledegg", "cam01"),
    ("P34_friedegg", "cam01"),
    ("P54_pancake", "cam01"),
    ("P52_pancake", "webcam01"),
]


class BreakfastVideo(Video):
    def load_features(self):
        feats = np.load(os.path.join(self._feature_root, "{}.npy".format(self.name)))
        return feats[1:, 1:]


class BreakfastDatasplit(Datasplit):
    def __init__(
        self,
        corpus,
        remove_background,
        task_filter=None,
        splits=None,
        full=True,
        subsample=1,
        feature_downscale=1.0,
        feature_permutation_seed=None,
    ):
        if splits is None:
            splits = list(sorted(BreakfastCorpus.DATASPLITS.keys()))
        self._splits = splits
        self._tasks = BreakfastCorpus.TASKS[:] if task_filter is None else task_filter
        self._p_files = []
        assert all(split in BreakfastCorpus.DATASPLITS for split in splits)
        for split, p_files in sorted(BreakfastCorpus.DATASPLITS.items()):
            if split in splits:
                assert len(set(p_files) & set(self._p_files)) == 0
                self._p_files.extend(p_files)
        super().__init__(
            corpus,
            remove_background=remove_background,
            full=full,
            subsample=subsample,
            feature_downscale=feature_downscale,
            feature_permutation_seed=feature_permutation_seed,
        )

    def _load_ground_truth_and_videos(self, remove_background):
        self.groundtruth = BreakfastGroundTruth(
            self._corpus,
            task_names=self._tasks,
            p_files=self._p_files,
            remove_background=remove_background,
        )
        k_by_task = {}
        for task, gts in self.groundtruth.gt_by_task.items():
            uniq_labels = set()
            for _, labels in gts.items():
                uniq_labels |= set(labels_t[0] for labels_t in labels)
            assert -1 not in uniq_labels
            k_by_task[task] = len(uniq_labels)
        self._K_by_task = k_by_task
        self._init_videos()

    def _init_videos(self):
        gt_stat = Counter()
        video_names = set()
        for root, dirs, files in os.walk(self._corpus._feature_root):
            for filename in files:
                if not filename.endswith(".npy"):
                    continue
                matching_tasks = [t for t in self._tasks if t in filename]
                assert len(matching_tasks) <= 1
                if not matching_tasks:
                    continue
                task = matching_tasks[0]
                gt_name = re.match(r"(\w*)\.\w*", filename).group(1)
                p_name = gt_name.split("_")[0]
                if p_name not in self._p_files:
                    continue
                if gt_name not in self.groundtruth.gt_by_task.get(task, {}):
                    logger.debug(
                        "skipping video {} with no ground truth".format(gt_name)
                    )
                    continue
                if not self._full and len(self._videos_by_task.get(task, {})) > 10:
                    continue
                nonbackground_timesteps = (
                    self.groundtruth.nonbackground_timesteps_by_task[task][gt_name]
                    if self._remove_background
                    else None
                )
                video = BreakfastVideo(
                    root,
                    remove_background=self._remove_background,
                    nonbackground_timesteps=nonbackground_timesteps,
                    K=self._K_by_task[task],
                    gt=self.groundtruth.gt_by_task[task][gt_name],
                    gt_with_background=self.groundtruth.gt_with_background_by_task[task][
                        gt_name
                    ],
                    name=gt_name,
                    cache_features=self._corpus._cache_features,
                    feature_permutation_seed=self._feature_permutation_seed,
                )
                self._videos_by_task.setdefault(task, {})
                assert video.name not in self._videos_by_task[task]
                self._videos_by_task[task][video.name] = video
                video_names.add(video.name)
                gt_stat.update(
                    labels_t[0] for labels_t in self.groundtruth.gt_by_task[task][gt_name]
                )
        logger.debug(
            "{} tasks, {} videos found for p_files {}".format(
                len(self._videos_by_task), len(video_names), self._p_files
            )
        )
        logger.debug("gt statistic: " + str(gt_stat))


class BreakfastCorpus(Corpus):
    BACKGROUND_LABELS = ["SIL"]

    TASKS = [
        "coffee", "cereals", "tea", "milk", "juice",
        "sandwich", "scrambledegg", "friedegg", "salat", "pancake",
    ]

    DATASPLITS = {
        "s1": ["P{:02d}".format(d) for d in range(3, 16)],
        "s2": ["P{:02d}".format(d) for d in range(16, 29)],
        "s3": ["P{:02d}".format(d) for d in range(29, 42)],
        "s4": ["P{:02d}".format(d) for d in range(42, 55)],
    }
    assert all_equal(len(v) for v in DATASPLITS.values())

    def __init__(self, mapping_file, feature_root, label_root, task_specific_steps=False):
        self._mapping_file = mapping_file
        self._feature_root = feature_root
        self._label_root = label_root
        self._task_specific_steps = task_specific_steps
        assert not task_specific_steps
        self.annotate_background_with_previous = False
        super().__init__(background_labels=self.BACKGROUND_LABELS)

    def _get_components_for_label(self, label):
        return label.split("_")

    def _load_mapping(self):
        with open(self._mapping_file, "r") as f:
            for line in f:
                index, label = line.strip().split()
                index = int(index)
                _index = self._index(label)
                if label in self._background_labels:
                    assert index in self._background_indices
                if index in self._background_indices:
                    assert label in self._background_labels
                assert _index == index

    def get_datasplit(
        self,
        remove_background,
        task_filter=None,
        splits=None,
        full=True,
        subsample=1,
        feature_downscale=1.0,
        feature_permutation_seed=None,
    ):
        return BreakfastDatasplit(
            self,
            remove_background,
            task_filter=task_filter,
            splits=splits,
            full=full,
            subsample=subsample,
            feature_downscale=feature_downscale,
            feature_permutation_seed=feature_permutation_seed,
        )


def datasets_by_task(
    mapping_file,
    feature_root,
    label_root,
    remove_background,
    task_ids=None,
    splits=None,
    full=True,
):
    if task_ids is None:
        task_ids = BreakfastCorpus.TASKS
    if splits is None:
        splits = list(BreakfastCorpus.DATASPLITS.keys())
    corpus = BreakfastCorpus(mapping_file, feature_root, label_root)
    return {
        task_id: corpus.get_datasplit(remove_background, [task_id], splits, full)
        for task_id in task_ids
    }


class BreakfastGroundTruth(GroundTruth):
    def __init__(self, corpus, task_names, p_files, remove_background):
        self._p_files = set(p_files)
        super().__init__(corpus, task_names, remove_background)

    def _load_gt(self):
        annotation_count = 0
        for root, dirs, files in os.walk(self._corpus._label_root):
            for filename in files:
                if not filename.endswith(".txt"):
                    continue
                p_file = filename.split("_")[0]
                if p_file not in self._p_files:
                    continue
                matching_tasks = [t for t in self._task_names if t in filename]
                assert len(matching_tasks) <= 1
                if not matching_tasks:
                    continue
                task = matching_tasks[0]

                gt = []
                order = []
                with open(os.path.join(root, filename), "r") as f:
                    for line in f:
                        match = re.match(r"(\d*)-(\d*)\s*(\w*)", line)
                        start = int(match.group(1))
                        end = int(match.group(2))
                        if end < start:
                            assert match.group(3) == self._corpus.BACKGROUND_LABELS[0]
                            continue
                        if start > len(gt) + 1:
                            # annotation gap: the reference appends
                            # contiguously anyway (breakfast.py:232-236),
                            # shifting every later label earlier. Keep
                            # its behavior (Table-2 parity) but surface
                            # the misalignment instead of silence.
                            logger.warning(
                                "{}: segment starts at {} but only {} "
                                "frames annotated — labels after the gap "
                                "shift earlier (reference parity)".format(
                                    filename, start, len(gt)
                                )
                            )
                        assert start > len(gt) - 1
                        label_idx = self._corpus._index(match.group(3))
                        gt += [[label_idx]] * (end - start + 1)
                        order.append((label_idx, start, end))
                annotation_count += 1

                up_to_cam, cam_name = os.path.split(root)
                if cam_name == "stereo":
                    cam_name = "stereo01"
                _, p_name = os.path.split(up_to_cam)

                match = re.match(r"(\w*)_ch(\d+)\.\w*", filename)
                if match:
                    gt_name = match.group(1)
                else:
                    gt_name = re.match(r"(\w*)\.\w*", filename).group(1)

                if (gt_name, cam_name) in MISMATCH_BLACKLIST:
                    continue

                vid_name = "{}_{}_{}".format(p_name, cam_name, gt_name)
                self.order_by_task.setdefault(task, {})[vid_name] = order
                self.gt_by_task.setdefault(task, {})[vid_name] = gt
        logger.debug("{} annotation files found".format(annotation_count))


def extract_feature_groups(corpus):
    grouped = {"reduced_64": {}}
    for idx in range(len(corpus)):
        instance = corpus._get_by_index(idx)
        if instance is None:
            # unloadable video (skipped with a warning by __getitem__);
            # skip it here too rather than abort the export
            continue
        grouped["reduced_64"][instance["video_name"]] = instance["features"][:, 0:64]
    return grouped


def pca_and_serialize_features(
    mapping_file,
    feature_root,
    label_root,
    output_feature_root,
    remove_background,
    pca_components_per_group=64,
    by_task=True,
    task_ids=None,
    device=None,
):
    """Fit per-task PCA and write per-video .npy files; the PCA runs on
    `device` (None: the card)."""
    all_splits = list(BreakfastCorpus.DATASPLITS.keys())
    if by_task:
        grouped_datasets = datasets_by_task(
            mapping_file, feature_root, label_root, remove_background,
            task_ids=task_ids, splits=all_splits, full=True,
        )
    else:
        corpus = BreakfastCorpus(mapping_file, feature_root, label_root)
        grouped_datasets = {"all": corpus.get_datasplit(remove_background, splits=all_splits)}

    os.makedirs(output_feature_root, exist_ok=True)
    for corpora_group, dataset in grouped_datasets.items():
        logger.debug("saving features for task: {}".format(corpora_group))
        grouped_features = extract_feature_groups(dataset)
        transformed, _ = grouped_pca(grouped_features, pca_components_per_group, device=device)
        for feature_group, vid_dict in transformed.items():
            feature_group_dir = os.path.join(output_feature_root, feature_group)
            os.makedirs(feature_group_dir, exist_ok=True)
            for vid, features in vid_dict.items():
                np.save(os.path.join(feature_group_dir, "{}.npy".format(vid)), features)


if __name__ == "__main__":
    # DATA_ROOT env overrides the reference's hardcoded ./data layout
    # (reference breakfast.py:362-377); see crosstask.py __main__
    _root = os.environ.get("DATA_ROOT", "data")
    _mapping_file = os.path.join(_root, "breakfast/mapping.txt")
    _feature_root = os.path.join(_root, "breakfast/reduced_fv_64")
    _label_root = os.path.join(_root, "breakfast/BreakfastII_15fps_qvga_sync")
    _components = 64
    for _remove_background in [False, True]:
        _output_feature_root = os.path.join(
            _root, "breakfast/breakfast_processed/breakfast_pca-{}_{}_{}"
        ).format(
            _components,
            "no-bkg" if _remove_background else "with-bkg",
            "by-task",
        )
        pca_and_serialize_features(
            _mapping_file,
            _feature_root,
            _label_root,
            _output_feature_root,
            _remove_background,
            pca_components_per_group=_components,
            by_task=True,
        )
