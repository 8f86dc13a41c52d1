"""Generate miniature CrossTask-format datasets on disk.

Writes a tiny release (tasks_primary.txt / tasks_related.txt /
videos.csv / annotations / constraints / per-group PCA feature dirs)
with class-separable Gaussian features, in exactly the layout the real
loaders parse (reference crosstask.py:18-171). Used by the tests and by
chip_smoke.py to drive the data path without the real corpus. The same
``RandomState`` writes the same bytes as the JAX package's twin.
"""

import os

import numpy as np

TASKS = {
    16815: ["stepA", "stepB", "stepC"],
    23521: ["stepX", "stepY"],
}
RELATED_TASKS = {
    1373: ["stepR1", "stepR2"],
}
N_TRAIN = 4
N_VAL = 2
DIM_PER_GROUP = 4
SHIFT = 3.0


def write_mini_crosstask(
    root,
    rng,
    tasks=None,
    related_tasks=None,
    n_train=N_TRAIN,
    n_val=N_VAL,
    dim_per_group=DIM_PER_GROUP,
    shift=SHIFT,
    bkg_range=(2, 5),
    step_range=(3, 8),
    gap_range=(1, 4),
    related_counts=None,
):
    """Write the mini release under `root`; returns {video: gt frame labels}.

    Durations are drawn per segment from the given [lo, hi) ranges, so
    larger ranges produce longer videos (for throughput-oriented runs).
    `related_counts` (n_train, n_val) gives the related tasks' videos
    their own counts (by default n_train and n_val, as the primary's).
    """
    tasks = TASKS if tasks is None else tasks
    related_tasks = RELATED_TASKS if related_tasks is None else related_tasks
    release = os.path.join(root, "crosstask", "crosstask_release")
    os.makedirs(os.path.join(release, "annotations"), exist_ok=True)
    constraints = os.path.join(root, "crosstask", "crosstask_constraints")
    os.makedirs(constraints, exist_ok=True)
    pca_root = os.path.join(
        root,
        "crosstask",
        "crosstask_processed",
        "crosstask_primary_pca-200_with-bkg_by-task",
    )
    for group in ("i3d", "resnet", "audio"):
        os.makedirs(os.path.join(pca_root, group), exist_ok=True)

    with open(os.path.join(release, "tasks_primary.txt"), "w") as f:
        for task_id, steps in tasks.items():
            f.write(f"{task_id}\ntask {task_id}\nhttp://x\n{len(steps)}\n")
            f.write(",".join(steps) + "\n\n")
    with open(os.path.join(release, "tasks_related.txt"), "w") as f:
        for task_id, steps in related_tasks.items():
            f.write(f"{task_id}\ntask {task_id}\nhttp://x\n{len(steps)}\n")
            f.write(",".join(steps) + "\n\n")

    videos = []
    val_videos = []
    gt_frames = {}
    for task_id, steps in {**tasks, **related_tasks}.items():
        n_tr, n_va = (related_counts if related_counts is not None and task_id in related_tasks
                      else (n_train, n_val))
        for i in range(n_tr + n_va):
            vid = f"v{task_id}_{i}"
            videos.append((task_id, vid))
            if i >= n_tr:
                val_videos.append((task_id, vid))
            # segments: bkg, step1, bkg, step2, ... with random durations
            rows = []
            t = rng.randint(*bkg_range)
            frame_labels = [0] * t
            for s_ix in range(len(steps)):
                dur = rng.randint(*step_range)
                rows.append((s_ix + 1, t, t + dur))
                frame_labels.extend([s_ix + 1] * dur)
                t += dur
                gap = rng.randint(*gap_range)
                frame_labels.extend([0] * gap)
                t += gap
            T = len(frame_labels)
            gt_frames[vid] = np.array(frame_labels)
            with open(
                os.path.join(release, "annotations", f"{task_id}_{vid}.csv"), "w"
            ) as f:
                for step, s, e in rows:
                    f.write(f"{step},{s},{e}\n")
            with open(os.path.join(constraints, f"{task_id}_{vid}.csv"), "w") as f:
                for step, s, e in rows:
                    f.write(f"{step},{s},{e}\n")
            # informative per-group features: class-shifted gaussians
            for g_ix, group in enumerate(("i3d", "resnet", "audio")):
                feats = rng.randn(T, dim_per_group).astype(np.float32)
                for t_ix, lab in enumerate(frame_labels):
                    feats[t_ix, lab % dim_per_group] += shift * (1 + 0.1 * g_ix)
                np.save(os.path.join(pca_root, group, f"{vid}.npy"), feats)

    with open(os.path.join(release, "videos.csv"), "w") as f:
        for task_id, vid in videos:
            f.write(f"{task_id},{vid},http://u\n")
    with open(os.path.join(release, "videos_val.csv"), "w") as f:
        for task_id, vid in val_videos:
            f.write(f"{task_id},{vid},http://u\n")
    return gt_frames


BREAKFAST_TASKS = {
    "coffee": ["pour_coffee", "pour_milk"],
    "tea": ["add_teabag", "pour_water"],
}
BREAKFAST_LABELS = ["SIL", "pour_coffee", "pour_milk", "add_teabag", "pour_water"]
BREAKFAST_DIM = 6
BREAKFAST_PARTICIPANTS = ["P03", "P16", "P29", "P42"]  # one per split s1-s4


def write_mini_breakfast(root, rng, dur_range=(4, 9), dim=BREAKFAST_DIM, shift=SHIFT):
    """Write a miniature Breakfast layout (mapping.txt, per-participant
    annotation txts under camera dirs, fisher-vector .npy features with
    the reference's first-row/column convention); returns the breakfast
    dir. Layout matches reference breakfast.py:142-377."""
    bdir = os.path.join(root, "breakfast")
    feat_dir = os.path.join(bdir, "reduced_fv_64")
    label_dir = os.path.join(bdir, "BreakfastII_15fps_qvga_sync")
    os.makedirs(feat_dir, exist_ok=True)
    with open(os.path.join(bdir, "mapping.txt"), "w") as f:
        for i, lab in enumerate(BREAKFAST_LABELS):
            f.write(f"{i} {lab}\n")

    for p in BREAKFAST_PARTICIPANTS:
        cam = "cam01"
        os.makedirs(os.path.join(label_dir, p, cam), exist_ok=True)
        for task, steps in BREAKFAST_TASKS.items():
            # segments: SIL, step1, SIL, step2, SIL
            segs = []
            t = 1
            labels = []
            for lab in ["SIL", steps[0], "SIL", steps[1], "SIL"]:
                dur = rng.randint(*dur_range)
                segs.append((lab, t, t + dur - 1))
                labels.extend([BREAKFAST_LABELS.index(lab)] * dur)
                t += dur
            gt_name = f"{p}_{task}"
            with open(os.path.join(label_dir, p, cam, f"{gt_name}.txt"), "w") as f:
                for lab, s, e in segs:
                    f.write(f"{s}-{e} {lab}\n")
            T = len(labels)
            feats = rng.randn(T + 1, dim + 1).astype(np.float32)
            for t_ix, lab in enumerate(labels):
                feats[t_ix + 1, 1 + (lab % dim)] += shift
            vid_name = f"{p}_{cam}_{gt_name}"
            np.save(os.path.join(feat_dir, f"{vid_name}.npy"), feats)
    return bdir
