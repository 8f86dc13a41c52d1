"""The command line's data flags and splits.

Twin of the JAX package's ``main.py`` for the data path only:
``add_data_args`` (the same flags) and ``make_data_splits``, which builds
the CrossTask or Breakfast corpus and its (train, train subset, test)
datasplits from the flags. The rest of the command line (``main``,
``train``, ``test``, the model and prediction files, the comparison
folder's flags) comes with the CLI slice.
"""

import os
from collections import OrderedDict

from action_segmentation_torch.data.breakfast import BreakfastCorpus
from action_segmentation_torch.data.crosstask import CrosstaskCorpus


def add_data_args(parser):
    group = parser.add_argument_group("data")
    group.add_argument("--dataset", choices=["crosstask", "breakfast"], default="crosstask")
    group.add_argument("--features", choices=["raw", "pca"], default="pca")
    group.add_argument("--feature_downscale", type=float, default=1.0)
    group.add_argument("--feature_permutation_seed", type=int)
    group.add_argument("--batch_size", type=int, default=5)
    group.add_argument("--remove_background", action="store_true")
    group.add_argument("--pca_components_per_group", type=int, default=100)
    group.add_argument("--pca_no_background", action="store_true")
    group.add_argument("--mix_tasks", action="store_true")
    group.add_argument("--frame_subsample", type=int, default=1)
    group.add_argument("--task_specific_steps", action="store_true")
    group.add_argument("--annotate_background_with_previous", action="store_true")
    group.add_argument("--no_merge_classes", action="store_true")
    group.add_argument("--force_optimal_assignment", action="store_true")
    group.add_argument("--no_cache_features", action="store_true")
    group.add_argument(
        "--crosstask_feature_groups",
        choices=["i3d", "resnet", "audio", "narration"],
        nargs="+",
        default=["i3d", "resnet", "audio"],
    )
    group.add_argument(
        "--crosstask_training_data",
        choices=["primary", "related"],
        nargs="+",
        default=["primary"],
    )
    group.add_argument("--crosstask_cross_validation", action="store_true")
    group.add_argument("--crosstask_cross_validation_seed", type=int)
    group.add_argument("--data_root", default="data")


def make_data_splits(args):
    splits = OrderedDict()
    root = args.data_root

    if args.dataset == "crosstask":
        features_contain_background = True
        if args.features == "pca":
            max_components = 200
            assert args.pca_components_per_group <= max_components
            features_contain_background = not args.pca_no_background
            feature_root = os.path.join(
                root,
                "crosstask/crosstask_processed/crosstask_primary_pca-{}_{}-bkg_by-task".format(
                    max_components, "no" if args.pca_no_background else "with"
                ),
            )
            dimensions_per_feature_group = {
                fg: args.pca_components_per_group
                for fg in args.crosstask_feature_groups
            }
        else:
            feature_root = os.path.join(root, "crosstask/crosstask_features")
            dimensions_per_feature_group = None

        corpus = CrosstaskCorpus(
            release_root=os.path.join(root, "crosstask/crosstask_release"),
            feature_root=feature_root,
            dimensions_per_feature_group=dimensions_per_feature_group,
            features_contain_background=features_contain_background,
            task_specific_steps=args.task_specific_steps,
            annotate_background_with_previous=args.annotate_background_with_previous,
            use_secondary="related" in args.crosstask_training_data,
            constraints_root=os.path.join(root, "crosstask/crosstask_constraints"),
            load_constraints=True,
        )
        corpus._cache_features = not args.no_cache_features
        train_task_sets = args.crosstask_training_data
        test_task_sets = ["primary"]
        task_ids = sorted(
            task_id
            for task_set in sorted(set(train_task_sets) | set(test_task_sets))
            for task_id in CrosstaskCorpus.TASK_IDS_BY_SET[task_set]
        )
        if args.crosstask_cross_validation:
            if train_task_sets != ["primary"]:
                raise NotImplementedError("cross validation with related tasks")
            split_names_and_full = [
                ("cv_train_{}".format(args.crosstask_cross_validation_seed), True, train_task_sets),
                ("cv_train_{}".format(args.crosstask_cross_validation_seed), False, train_task_sets),
                ("cv_test_{}".format(args.crosstask_cross_validation_seed), True, train_task_sets),
            ]
        else:
            split_names_and_full = [
                ("train", True, train_task_sets),
                ("train", False, test_task_sets),
                ("val", True, test_task_sets),
            ]
        def get_splits(task_ids_subset):
            return tuple(
                corpus.get_datasplit(
                    remove_background=args.remove_background,
                    task_sets=task_sets,
                    task_ids=task_ids_subset,
                    split=split,
                    full=full,
                    subsample=args.frame_subsample,
                    feature_downscale=args.feature_downscale,
                    feature_permutation_seed=args.feature_permutation_seed,
                )
                for split, full, task_sets in split_names_and_full
            )

        if args.mix_tasks:
            splits["all"] = get_splits(task_ids)
            train_videos = set(p[1] for p in splits["all"][0]._tasks_and_video_names)
            test_videos = set(p[1] for p in splits["all"][2]._tasks_and_video_names)
            assert not (train_videos & test_videos)
        else:
            for task_id in task_ids:
                splits["{}_val".format(task_id)] = get_splits([task_id])

    elif args.dataset == "breakfast":
        assert not args.annotate_background_with_previous
        if args.features == "pca":
            max_components = 64
            assert args.pca_components_per_group == max_components
            assert not args.pca_no_background, "not implemented"
            feature_root = os.path.join(
                root,
                "breakfast/breakfast_processed/breakfast_pca-{}_{}-bkg_by-task".format(
                    max_components, "with"
                ),
            )
        else:
            feature_root = os.path.join(root, "breakfast/reduced_fv_64")
        corpus = BreakfastCorpus(
            mapping_file=os.path.join(root, "breakfast/mapping.txt"),
            feature_root=feature_root,
            label_root=os.path.join(root, "breakfast/BreakfastII_15fps_qvga_sync"),
            task_specific_steps=args.task_specific_steps,
        )
        corpus._cache_features = True
        all_splits = list(sorted(BreakfastCorpus.DATASPLITS.keys()))
        for heldout_split in all_splits:
            # one train datasplit serves as train and train subset: both
            # are built from the same arguments and decode the same videos
            train_ds = corpus.get_datasplit(
                remove_background=args.remove_background,
                splits=[sp for sp in all_splits if sp != heldout_split],
                full=True,
                subsample=args.frame_subsample,
                feature_downscale=args.feature_downscale,
                feature_permutation_seed=args.feature_permutation_seed,
            )
            splits[heldout_split] = (
                train_ds,
                train_ds,
                corpus.get_datasplit(
                    remove_background=args.remove_background,
                    splits=[heldout_split],
                    full=True,
                    subsample=args.frame_subsample,
                    feature_downscale=args.feature_downscale,
                    feature_permutation_seed=args.feature_permutation_seed,
                ),
            )
    else:
        raise NotImplementedError("invalid dataset {}".format(args.dataset))
    return splits
